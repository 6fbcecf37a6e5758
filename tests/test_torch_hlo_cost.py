"""The port's cost count (``repro_torch/analysis/hlo_cost.py``) against the
reference's HLO cost walk (``repro/analysis/hlo_cost.py``) and against
itself.

  * qwen3-0.6b's full-width forward (B = 2, S = 64, bf16): ``count_step``'s
    FLOPs are within 3% of the reference's ``analyze_hlo`` of its jitted,
    compiled forward (read 0.985: the reference counts XLA's elementwise
    ops, the port its eager ones).
  * The trip-count rule: on the smoke configs of every assigned arch at 4
    layers (the Mamba archs through their time loop), and qwen3 under a
    per-layer assignment of two kinds, ``count_cell`` gives the whole
    model's FLOPs by class, bytes, collectives by axis and kind, and kernel
    counts exactly, for train, prefill and decode cells on a (data, model)
    = (2, 2) mesh over torch's fake process group (started and destroyed
    by a module fixture).
  * The kernels: ``elementwise_2d`` and ``glu_2d`` count once per launch at
    their own formula (``kernels/epilogue.py::elementwise_work`` /
    ``glu_work``), never the plain route's internals, and a train step of
    qwen3 smoke fused and kernelized counts the same on the CPU (the plain
    route) as on meta tensors (the meta contract).
  * ``_grouped_mm``: 2 x rows x d x f and torch's output shapes, on meta
    tensors whatever their type; the memory of a scripted function.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import hlo_cost as H  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.kernels import epilogue as epi  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import shapes as TSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = sorted(TR.assigned_archs())
REF_RATIO_TOL = 0.03
ALL_CELLS = ("falcon-mamba-7b", "mixtral-8x22b", "qwen3-0.6b:per_layer")
CELLS = {"train": TSH.ShapeCell("train", 8, 8, "train"),
         "prefill": TSH.ShapeCell("prefill", 8, 8, "prefill"),
         "decode": TSH.ShapeCell("decode", 16, 8, "decode")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A (2, 2) mesh on the meta device over a fake group of 4 ranks."""
    D.start_fake_group(4)
    try:
        yield LM.make_mesh_auto((2, 2), ("data", "model"), device="meta")
    finally:
        D.stop_fake_group()


def _counts(t):
    """Every count but the memory (which the trip-count rule estimates)."""
    return {k: v for k, v in t.numbers().items()
            if not (isinstance(k, tuple) and k[0] == "memory")}


def test_forward_flops_match_the_reference_hlo_walk():
    import jax
    import jax.numpy as jnp

    from repro.analysis import hlo_cost as JH
    from repro.configs import registry as JR
    from repro.launch import steps as JS
    from repro.models import model as JM
    B, S = 2, 64
    jc = JR.get("qwen3-0.6b")
    shapes, _ = JM.abstract_params(jc)
    eng = JS.make_engine(jc)
    fwd = jax.jit(lambda p, b: JM.forward_fn(p, b, jc, eng))
    text = fwd.lower(shapes, {"tokens": jax.ShapeDtypeStruct(
        (B, S), jnp.int32)}).compile().as_text()
    ref = JH.analyze_hlo(text)
    tc = TR.get("qwen3-0.6b")
    pshapes, _ = TM.abstract_params(tc)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    engine = TS.make_engine(tc)
    got = H.count_step(lambda p, b: TM.forward_fn(p, b, tc, engine),
                       pshapes, {"tokens": tokens})
    assert abs(got.flops / ref.flops - 1) <= REF_RATIO_TOL, \
        (got.flops, ref.flops)
    # the matmuls: 2 x tokens x the params they touch, the head in f32
    d, V = tc.d_model, tc.padded_vocab
    assert got.flops_by_dtype["float32"] >= 2 * B * S * d * V


def _deep(cfg, n=4):
    return dataclasses.replace(cfg, n_layers=n)


def _per_layer(cfg, n=4):
    return dataclasses.replace(cfg, n_layers=n,
                               act_layers=("cr-d32",) * 3 + ("pwl-d16",))


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b:per_layer"])
def test_trip_count_rule_equals_the_whole_count(mesh, arch):
    """count_cell = the whole model's count for every count but memory;
    the memory's argument bytes too, and its peak estimate within 35%.
    Every arch's train cell; the prefill and decode cells too of the
    archs whose layers differ most (MoE, Mamba, two kinds)."""
    name, _, dep = arch.partition(":")
    cfg = TR.get(name, smoke=True)
    cfg = _per_layer(cfg) if dep else _deep(cfg)
    cells = CELLS if arch in ALL_CELLS else {"train": CELLS["train"]}
    for cell in cells.values():
        whole = H.count_cell(cfg, cell, mesh, whole=True)
        cut = H.count_cell(cfg, cell, mesh)
        assert _counts(cut) == _counts(whole), (arch, cell.name)
        assert cut.memory["argument_bytes"] == whole.memory["argument_bytes"]
        assert abs(cut.memory["peak_bytes"] / whole.memory["peak_bytes"]
                   - 1) <= 0.35, (arch, cell.name, cut.memory, whole.memory)
        assert whole.collectives_by_axis["model"]["all-reduce"][0] > 0
        if cell.kind == "train":
            assert whole.collectives_by_axis["data"]["all-gather"][0] > 0


@pytest.mark.parametrize("kernel", ["elementwise_2d", "glu_2d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_kernel_counts_its_own_work_on_every_route(kernel, dtype):
    dt = getattr(torch, dtype)
    spec = epi.TableSpec.of(epi.table_for("silu", 4.0, 32))
    gen = torch.Generator().manual_seed(0)
    p = torch.as_tensor(epi.table_for("silu", 4.0, 32).windows,
                        dtype=torch.float32)
    x = torch.randn((6, 40), generator=gen).to(dt)
    w = torch.randn((40, 24), generator=gen).to(dt)
    if kernel == "glu_2d":
        call = lambda x, w, p: epi.glu_2d(x, w, w, p, spec=spec)
        flops, nbytes = epi.glu_work(x, w, p, spec, "silu")
        assert flops == {dtype: 4 * 6 * 40 * 24,
                         "vector": 6 * 24 * (4 + 1 + 3 + 35)}
    else:
        call = lambda x, w, p: epi.elementwise_2d(x, p, spec=spec, act="silu")
        flops, nbytes = epi.elementwise_work(x, p, spec, "silu")
        assert flops == {"vector": 6 * 40 * (4 + 1 + 3 + 35)}
    for dev in ("cpu", "meta"):
        got = H.count_step(call, x.to(dev), w.to(dev), p.to(dev))
        assert got.kernels == {kernel: 1}, dev
        assert got.flops_by_dtype == flops, dev
        assert got.bytes == nbytes, dev
        assert got.flops == sum(flops.values())


@pytest.mark.parametrize("dep", ["fused", "kernelized"])
def test_train_step_counts_the_same_on_cpu_and_meta(dep):
    """One train step of qwen3 smoke (remat="block": each kernel twice a
    layer) counts the same through the plain route on CPU tensors as on
    meta tensors, each kernel at its launches."""
    base = _deep(TR.get("qwen3-0.6b", smoke=True), 2)
    cfg = fused_of(base) if dep == "fused" else act_impl_of(
        base, "cr_spline", use_kernel=True)
    kernel = "glu_2d" if dep == "fused" else "elementwise_2d"
    step = TS.make_train_step(cfg)
    out = {}
    for dev in ("cpu", "meta"):
        params = TM.materialize_params(cfg, seed=0, device="cpu")
        opt = adamw.init_state(params)
        tokens = torch.zeros((2, 8), dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens}
        move = lambda t: t.clone() if dev == "cpu" else t.to(dev)
        args = (adamw.tree_map(move, params), adamw.tree_map(move, opt),
                adamw.tree_map(move, batch), 1)
        step(*args)                       # warm the parameter caches
        out[dev] = H.count_step(step, *args)
    assert out["cpu"].kernels == {kernel: 2 * cfg.n_layers}
    assert _counts(out["cpu"]) == _counts(out["meta"])
    assert out["cpu"].memory == out["meta"].memory


@pytest.mark.parametrize("form", ["2dx3d", "2dx2d", "3dx3d"])
def test_grouped_mm_counts_and_meta_output(form):
    T, d, f, E = 12, 8, 4, 3
    a, b = {"2dx3d": ((T, d), (E, d, f)), "2dx2d": ((d, T), (T, f)),
            "3dx3d": ((E, T, d), (E, d, f))}[form]
    offs = torch.tensor([4, 8, 12], dtype=torch.int32)
    kw = {} if form == "3dx3d" else {"offs": offs}
    want = {"2dx3d": 2 * T * d * f, "2dx2d": 2 * d * T * f,
            "3dx3d": 2 * E * T * d * f}[form]
    xa, xb = torch.randn(a), torch.randn(b)
    got = H.count_step(lambda x, y: torch._grouped_mm(x, y, **kw), xa, xb)
    meta = H.count_step(lambda x, y: torch._grouped_mm(x, y, **kw),
                        xa.to("meta"), xb.to("meta"))
    assert got.flops_by_dtype == meta.flops_by_dtype == {"float32": want}
    ref = torch._grouped_mm(xa, xb, **kw)
    out = H.Counter("meta")
    with out:
        m = torch._grouped_mm(xa.to("meta"), xb.to("meta"), **kw)
    assert tuple(m.shape) == tuple(ref.shape) and m.dtype == ref.dtype


def test_memory_of_a_scripted_step():
    """Live bytes: a step's own allocations at their peak, its outputs
    fresh or aliasing an input (views are free)."""
    n = 4 * 1024

    def step(x):
        a = x * 2
        b = a.view(-1) + 1
        del a
        c = b * 3
        return c, x.view(-1)

    for dev in ("cpu", "meta"):
        t = H.count_step(step, torch.zeros(1024, device=dev))
        assert t.memory == {"argument_bytes": n, "output_bytes": 2 * n,
                            "alias_bytes": n, "peak_bytes": 2 * n,
                            "temp_bytes": n}, dev
        assert t.flops_by_dtype == {"vector": 3 * 1024}
        assert t.bytes == 3 * 2 * n
    assert np.isclose(H.combine([(3, t), (-1, t)], den=2).bytes, t.bytes)
