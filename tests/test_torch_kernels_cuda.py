"""The hand-written CUDA kernels against their plain PyTorch versions.

Card-only: every test here is marked ``cuda`` and skips without a CUDA
device (a CUDA kernel has no CPU mode). The file imports neither jax nor
the JAX package, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import approximant as tap  # noqa: E402
from repro_torch.kernels import epilogue as tepi  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

EPILOGUES = ("tanh", "sigmoid", "silu", "gelu_tanh", "softplus")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(shape, scale=6.0, seed=0):
    return np.random.RandomState(seed).uniform(-scale, scale, shape).astype(
        np.float32)


def assert_within_bf16_ulp(got, ref):
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
                     - 7)
    err = (got - ref).abs()
    assert bool((err <= ulp).all()), float(err.max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _table(act, dev):
    table = tepi.table_for(act, 4.0, 32)
    return tepi.TableSpec.of(table), torch.as_tensor(
        table.windows, dtype=torch.float32, device=dev)


# decode, prefill and the largest ragged prefill of the served model, a
# single element, a ragged edge inside one thread's vector, and odd shapes
ELEMENTWISE_SHAPES = ((2, 3072), (128, 3072), (256, 3072), (1, 1), (1, 9),
                      (37, 1000), (1, 3), (3, 5))


def _check_elementwise(spec, p, act, x):
    """One launch (counted once) against the plain version: f32 bitwise,
    bf16 within one ulp; then a second launch gives the same bits."""
    n0 = tepi.LAUNCHES["elementwise_2d"]
    y = tepi.elementwise_2d(x, p, spec=spec, act=act)
    torch.cuda.synchronize()
    assert tepi.LAUNCHES["elementwise_2d"] == n0 + 1
    yp = tepi.elementwise_2d_plain(x, p, spec=spec, act=act)
    if x.dtype == torch.float32:
        assert torch.equal(y, yp), float((y - yp).abs().max())
    else:
        assert_within_bf16_ulp(y, yp)
    assert torch.equal(tepi.elementwise_2d(x, p, spec=spec, act=act), y)


@pytest.mark.parametrize("act", EPILOGUES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elementwise_kernel_matches_plain(cuda, act, dtype):
    dt = getattr(torch, dtype)
    spec, p = _table(act, cuda)
    for shape in ELEMENTWISE_SHAPES:
        x = torch.from_numpy(rand(shape, seed=shape[0])).to(cuda, dt)
        _check_elementwise(spec, p, act, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elementwise_unaligned_input_takes_scalar_path(cuda, dtype):
    """An input one element past 16-byte alignment, at a decode and at a
    prefill shape: the kernel reads and writes it element by element."""
    dt = getattr(torch, dtype)
    spec, p = _table("silu", cuda)
    for rows, cols in ((1, 999), (128, 3072)):
        base = torch.from_numpy(rand((rows * cols + 1,), seed=2)).to(cuda, dt)
        x = base[1:].reshape(rows, cols)   # contiguous, one element off
        assert x.data_ptr() % 16 != 0
        _check_elementwise(spec, p, "silu", x)


@pytest.mark.parametrize("geometry", [(5, 128, 8), (7, 128, 8), (12, 128, 4),
                                      (16, 48, 8), (3, 288, 8)],
                         ids=["short", "block-past-n", "ept-4", "threads-48",
                              "threads-288"])
def test_elementwise_refused_geometry_raises(cuda, monkeypatch, geometry):
    """The C side refuses a geometry that does not cover n, has a block
    wholly past n, an ept it has no kernel for, or threads that are not
    whole warps within the launch bound; the wrapper raises and counts
    nothing."""
    spec, p = _table("silu", cuda)
    x = torch.zeros((2, 3072), dtype=torch.bfloat16, device=cuda)
    monkeypatch.setattr(tepi, "_elementwise_geometry", lambda *a: geometry)
    n0 = tepi.LAUNCHES["elementwise_2d"]
    with pytest.raises(RuntimeError, match="elementwise_2d"):
        tepi.elementwise_2d(x, p, spec=spec, act="silu")
    assert tepi.LAUNCHES["elementwise_2d"] == n0


@pytest.mark.parametrize("act", EPILOGUES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_kernel_matches_plain(cuda, act, dtype):
    dt = getattr(torch, dtype)
    spec, p = _table(act, cuda)
    for m, k, n in ((4, 1024, 3072), (37, 300, 130), (130, 512, 256),
                    (1, 9, 5)):
        x = torch.from_numpy(rand((m, k), scale=1.0, seed=m)).to(cuda, dt)
        wg = torch.from_numpy(rand((k, n), scale=0.05, seed=k)).to(cuda, dt)
        wu = torch.from_numpy(rand((k, n), scale=0.05, seed=n)).to(cuda, dt)
        n0 = tepi.LAUNCHES["glu_2d"]
        y = tepi.glu_2d(x, wg, wu, p, spec=spec, act=act)
        torch.cuda.synchronize()
        assert tepi.LAUNCHES["glu_2d"] == n0 + 1
        yp = tepi.glu_2d_plain(x, wg, wu, p, spec=spec, act=act)
        if dt == torch.float32:
            torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-5)
        else:
            torch.testing.assert_close(y.float(), yp.float(), rtol=1e-2,
                                       atol=1e-3)


def test_ops_route_cuda_tensors_to_kernels(cuda):
    x = torch.from_numpy(rand((2, 3, 64), seed=4)).to(cuda)
    w = torch.from_numpy(rand((64, 32), scale=0.1, seed=5)).to(cuda)
    before = dict(tepi.LAUNCHES)
    y = tops.act(x, "gelu_tanh")
    g = tops.fused_glu(x, w, w, act="silu")
    assert tepi.LAUNCHES["elementwise_2d"] == before["elementwise_2d"] + 1
    assert tepi.LAUNCHES["glu_2d"] == before["glu_2d"] + 1
    torch.testing.assert_close(y.cpu(), tops.act(x.cpu(), "gelu_tanh"),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g.cpu(), tops.fused_glu(x.cpu(), w.cpu(),
                                                       w.cpu()),
                               rtol=1e-4, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    spec, p = _table("tanh", cuda)
    with pytest.raises(TypeError):
        tepi.elementwise_2d(torch.zeros(4, 4, dtype=torch.float16,
                                        device=cuda), p, spec=spec)
    with pytest.raises(ValueError):
        tepi.elementwise_2d(torch.zeros(4, 8, device=cuda).t(), p, spec=spec)
    with pytest.raises(ValueError):
        tepi.glu_2d(torch.zeros(4, 8, device=cuda),
                    torch.zeros(8, 4, device=cuda),
                    torch.zeros(8, 4, dtype=torch.bfloat16, device=cuda), p,
                    spec=spec)


# --- the pwl / poly / rational scheme datapaths ----------------------------

SCHEMES = ("pwl", "poly", "rational")
# every float geometry benchmarks/dse.py sweeps for these schemes
DSE_GEOMS = ([("pwl", dict(depth=d)) for d in (8, 16, 32, 64)]
             + [("poly", dict(depth=d, degree=g))
                for d, g in ((4, 2), (4, 3), (8, 3), (16, 3))]
             + [("rational", dict(degree=g)) for g in (3, 5, 7)])
# rational has no softplus: its build targets tanh only
SCHEME_ACTS = [(s, a) for s in SCHEMES for a in EPILOGUES
               if (s, a) != ("rational", "softplus")]


def _scheme(scheme, act, dev, **geom):
    spec = tap.spec_for(scheme, act, **geom)
    return spec, tap.params_on(spec, tap.target_of(act), dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme,act", SCHEME_ACTS)
def test_scheme_elementwise_kernel_matches_plain(cuda, scheme, act, dtype):
    dt = getattr(torch, dtype)
    spec, p = _scheme(scheme, act, cuda)
    for shape in ELEMENTWISE_SHAPES:
        x = torch.from_numpy(rand(shape, seed=shape[0] + 1)).to(cuda, dt)
        _check_elementwise(spec, p, act, x)


@pytest.mark.parametrize("scheme,act", SCHEME_ACTS)
def test_scheme_glu_kernel_matches_plain(cuda, scheme, act):
    spec, p = _scheme(scheme, act, cuda)
    for m, k, n in ((4, 1024, 3072), (37, 300, 130), (130, 512, 256)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rand((m, k), scale=1.0, seed=m)).to(cuda, dt)
            wg = torch.from_numpy(rand((k, n), scale=0.05, seed=k)).to(cuda,
                                                                       dt)
            wu = torch.from_numpy(rand((k, n), scale=0.05, seed=n)).to(cuda,
                                                                       dt)
            y = tepi.glu_2d(x, wg, wu, p, spec=spec, act=act)
            yp = tepi.glu_2d_plain(x, wg, wu, p, spec=spec, act=act)
            if dt == torch.float32:
                torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-5)
            else:
                torch.testing.assert_close(y.float(), yp.float(), rtol=1e-2,
                                           atol=1e-3)


@pytest.mark.parametrize("case", DSE_GEOMS,
                         ids=lambda c: c[0] + "-" + "-".join(
                             map(str, c[1].values())))
def test_scheme_kernels_at_dse_geometries(cuda, case):
    scheme, geom = case
    spec, p = _scheme(scheme, "tanh", cuda, **geom)
    x = torch.from_numpy(rand((37, 1000), seed=7)).to(cuda)
    y = tepi.elementwise_2d(x, p, spec=spec, act="silu")
    assert torch.equal(y, tepi.elementwise_2d_plain(x, p, spec=spec,
                                                    act="silu"))
    w = torch.from_numpy(rand((1000, 96), scale=0.05, seed=8)).to(cuda)
    torch.testing.assert_close(
        tepi.glu_2d(x, w, w, p, spec=spec, act="silu"),
        tepi.glu_2d_plain(x, w, w, p, spec=spec, act="silu"), rtol=1e-4,
        atol=1e-5)


@pytest.mark.parametrize("scheme", ("cr_spline",) + SCHEMES)
def test_scheme_kernel_tanh_on_q213_grid(cuda, scheme):
    """The kernel's tanh over the whole 2^16-point Q2.13 input grid stays
    within the reference's 0.03 of tanh (tests/test_approximant.py)."""
    spec, p = _scheme(scheme, "tanh", cuda)
    grid = (torch.arange(-2 ** 15, 2 ** 15, dtype=torch.float64)
            / 2 ** 13).to(cuda)
    y = tepi.elementwise_2d(grid.float().reshape(1, -1), p, spec=spec,
                            act="tanh")
    assert float((y.double().reshape(-1) - torch.tanh(grid)).abs().max()) \
        < 0.03


def test_scheme_kernel_refusals(cuda):
    spec, p = _scheme("rational", "tanh", cuda)
    with pytest.raises(ValueError, match="tanh only"):
        tepi.elementwise_2d(torch.zeros(4, 4, device=cuda), p, spec=spec,
                            act="softplus")
    big = tap.spec_for("pwl", depth=1025)
    with pytest.raises(ValueError, match="shared-memory"):
        tepi.elementwise_2d(torch.zeros(4, 4, device=cuda),
                            tap.params_on(big, "tanh", cuda), spec=big)


# --- glu_2d's TMA + wgmma variant -------------------------------------------

ALL_SCHEME_ACTS = [("cr_spline", a) for a in EPILOGUES] + SCHEME_ACTS
# ragged M (65 crosses a warpgroup, 300 a 256-row M tile), N and K
# (TMA's out-of-bounds fill), all addressable by TMA
GLU_TMA_RAGGED = ((65, 1000, 3000), (1, 1024, 136), (300, 64, 72),
                  (130, 512, 256), (17, 8, 8))
# the same for tma_f32 (K and N multiples of 4), across its 8-, 32- and
# 64-row tiles (65 and 300 cross 64-row M tiles) and its K split (K = 36:
# two K blocks, the second ragged)
GLU_TMA_F32_RAGGED = GLU_TMA_RAGGED + ((9, 1020, 3004), (33, 36, 4),
                                       (2, 4, 12))


def _any_scheme(scheme, act, dev):
    if scheme == "cr_spline":
        return _table(act, dev)
    return _scheme(scheme, act, dev)


def _bf16_operands(m, k, n, dev, seed=0):
    x = torch.from_numpy(rand((m, k), scale=1.0, seed=seed + m)).to(
        dev, torch.bfloat16)
    wg = torch.from_numpy(rand((k, n), scale=0.05, seed=seed + k)).to(
        dev, torch.bfloat16)
    wu = torch.from_numpy(rand((k, n), scale=0.05, seed=seed + n + 1)).to(
        dev, torch.bfloat16)
    return x, wg, wu


@pytest.mark.parametrize("scheme,act", ALL_SCHEME_ACTS)
def test_glu_tma_variant_ragged_shapes(cuda, scheme, act):
    spec, p = _any_scheme(scheme, act, cuda)
    for m, k, n in GLU_TMA_RAGGED:
        x, wg, wu = _bf16_operands(m, k, n, cuda)
        n0 = tepi.GLU_VARIANTS["tma_wgmma"]
        y = tepi.glu_2d(x, wg, wu, p, spec=spec, act=act)
        torch.cuda.synchronize()
        assert tepi.GLU_VARIANTS["tma_wgmma"] == n0 + 1, (m, k, n)
        torch.testing.assert_close(
            y.float(), tepi.glu_2d_plain(x, wg, wu, p, spec=spec,
                                         act=act).float(),
            rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("m", [2, 128, 256])
def test_glu_tma_variant_is_bitwise_deterministic(cuda, m):
    """The K split's cluster reduction sums the ranks' partials in a fixed
    order: repeated launches give the same bits."""
    spec, p = _table("silu", cuda)
    x, wg, wu = _bf16_operands(m, 1024, 3072, cuda, seed=3)
    first = tepi.glu_2d(x, wg, wu, p, spec=spec)
    for _ in range(4):
        assert torch.equal(tepi.glu_2d(x, wg, wu, p, spec=spec), first)


@pytest.mark.parametrize("scheme,act", ALL_SCHEME_ACTS)
def test_glu_tma_f32_variant_ragged_shapes(cuda, scheme, act):
    """tma_f32 at ragged M, N and K against the plain version at the f32
    tolerance (the K sums run in another order)."""
    spec, p = _any_scheme(scheme, act, cuda)
    for m, k, n in GLU_TMA_F32_RAGGED:
        x, wg, wu = (t.float() for t in _bf16_operands(m, k, n, cuda))
        n0 = tepi.GLU_VARIANTS["tma_f32"]
        y = tepi.glu_2d(x, wg, wu, p, spec=spec, act=act)
        torch.cuda.synchronize()
        assert tepi.GLU_VARIANTS["tma_f32"] == n0 + 1, (m, k, n)
        torch.testing.assert_close(
            y, tepi.glu_2d_plain(x, wg, wu, p, spec=spec, act=act),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m", [2, 32, 64, 128, 1024])
def test_glu_tma_f32_variant_is_bitwise_deterministic(cuda, m):
    """tma_f32 sums each thread's K rows in order, its K slices and its
    cluster's ranks in a fixed order: repeated launches give the same
    bits, at every tile."""
    spec, p = _table("silu", cuda)
    x, wg, wu = (t.float() for t in _bf16_operands(m, 1024, 3072, cuda,
                                                    seed=3))
    first = tepi.glu_2d(x, wg, wu, p, spec=spec)
    for _ in range(4):
        assert torch.equal(tepi.glu_2d(x, wg, wu, p, spec=spec), first)


def test_glu_variants_counted_on_the_ops_route(cuda):
    before = dict(tepi.GLU_VARIANTS)
    n_before = tepi.LAUNCHES["glu_2d"]
    x, wg, wu = _bf16_operands(2, 64, 32, cuda)
    tops.fused_glu(x.reshape(1, 2, 64), wg, wu, act="silu")     # TMA
    tops.fused_glu(x.float(), wg.float(), wu.float(), act="silu")   # f32
    x5, w5, _ = _bf16_operands(2, 64, 5, cuda)
    tops.fused_glu(x5, w5, w5, act="silu")                       # N = 5
    tops.fused_glu(x5.float(), w5.float(), w5.float(), act="silu")  # f32
    torch.cuda.synchronize()
    got = {k: tepi.GLU_VARIANTS[k] - before[k] for k in before}
    assert got == {"tma_wgmma": 1, "tma_f32": 1, "simt_f32": 1, "wmma": 1}
    assert tepi.LAUNCHES["glu_2d"] == n_before + 4


@pytest.mark.parametrize("forced,dtype,n", [
    ("tma_wgmma", torch.bfloat16, 3001),   # N's row stride: not addressable
    ("simt_f32", torch.bfloat16, 3072),    # wrong type for the variant
    ("wmma", torch.float32, 3072),
    ("tma_f32", torch.float32, 3001),      # N's row stride: not addressable
    ("tma_f32", torch.bfloat16, 3072),
])
def test_glu_wrapper_raises_when_the_variant_is_refused(cuda, monkeypatch,
                                                        forced, dtype, n):
    """The C side refuses a variant that does not fit the operands; the
    wrapper raises and runs nothing else (no retry, no plain version)."""
    spec, p = _table("silu", cuda)
    x, wg, wu = _bf16_operands(2, 1024, n, cuda)
    x, wg, wu = x.to(dtype), wg.to(dtype), wu.to(dtype)
    monkeypatch.setattr(tepi, "_glu_variant", lambda *a: forced)
    launches, variants = dict(tepi.LAUNCHES), dict(tepi.GLU_VARIANTS)
    with pytest.raises(RuntimeError, match=forced):
        tepi.glu_2d(x, wg, wu, p, spec=spec)
    assert tepi.LAUNCHES == launches and tepi.GLU_VARIANTS == variants


# --- gradients through the kernels and the train step -----------------------

def _route_grads(fn, inputs, g):
    """(output, gradients of <output, g> for every input) of ``fn``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, g)


def _assert_grads_bitwise(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), float(
            (a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme,act", ALL_SCHEME_ACTS)
def test_act_kernel_route_grads_equal_plain_route(cuda, scheme, act, dtype):
    """``ops.act`` on a CUDA tensor launches ``elementwise_2d`` once in the
    forward and none in the backward, which recomputes the plain version:
    the gradients for x and the params equal autograd through the plain
    version on the same inputs bit for bit, at the training row count
    and a ragged one."""
    dt = getattr(torch, dtype)
    spec, p = _any_scheme(scheme, act, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for m in (1024, 1000):
        x = (torch.randn((m, 3072), generator=gen, device=cuda) * 3).to(dt)
        g = torch.randn((m, 3072), generator=gen, device=cuda).to(dt)
        n0 = tepi.LAUNCHES["elementwise_2d"]
        y, gk = _route_grads(
            lambda x, p: tops.act(x, act, spec=spec, params=p), (x, p), g)
        torch.cuda.synchronize()
        assert tepi.LAUNCHES["elementwise_2d"] == n0 + 1
        yp, gp = _route_grads(
            lambda x, p: tepi.elementwise_2d_plain(
                x, p, spec=spec, act=act, lookup="take"), (x, p), g)
        _assert_grads_bitwise(gk, gp)
        if dt == torch.float32:
            assert torch.equal(y, yp)
        else:
            assert_within_bf16_ulp(y, yp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ("cr_spline",) + SCHEMES)
def test_glu_kernel_route_grads_equal_plain_route(cuda, scheme, dtype):
    """``ops.fused_glu`` likewise: one ``glu_2d`` launch, and gradients for
    x, w_gate, w_up and the params bitwise those of the plain version, at
    M = 1024 and 1000 (K = 1024, N = 3072, the training shapes)."""
    dt = getattr(torch, dtype)
    spec, p = _any_scheme(scheme, "silu", cuda)
    for m in (1024, 1000):
        x, wg, wu = (t.to(dt) for t in _bf16_operands(m, 1024, 3072, cuda))
        g = torch.from_numpy(rand((m, 3072), scale=1.0, seed=9)).to(cuda, dt)
        n0 = tepi.LAUNCHES["glu_2d"]
        y, gk = _route_grads(
            lambda x, wg, wu, p: tops.fused_glu(x, wg, wu, spec=spec,
                                                params=p), (x, wg, wu, p), g)
        torch.cuda.synchronize()
        assert tepi.LAUNCHES["glu_2d"] == n0 + 1
        yp, gp = _route_grads(
            lambda x, wg, wu, p: tepi.glu_2d_plain(
                x, wg, wu, p, spec=spec, act="silu", lookup="take"),
            (x, wg, wu, p), g)
        _assert_grads_bitwise(gk, gp)
        tol = (1e-4, 1e-5) if dt == torch.float32 else (1e-2, 1e-3)
        torch.testing.assert_close(y.float(), yp.float(), rtol=tol[0],
                                   atol=tol[1])


def _smoke_deployment(dep, dtype="bfloat16"):
    from repro_torch.configs import registry
    from repro_torch.configs.common import act_impl_of, fused_of
    cfg = registry.get("qwen3-0.6b", smoke=True, compute_dtype=dtype)
    if dep == "fused":
        return fused_of(cfg), "glu_2d"
    return act_impl_of(cfg, "cr_spline", use_kernel=True), "elementwise_2d"


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("block", 2)])
@pytest.mark.parametrize("dep", ["fused", "kernel"])
def test_train_step_launch_counts(cuda, dep, remat, per_layer):
    """Two bf16 train steps of each cr_spline deployment at smoke size:
    the path's kernel launches n_layers times a step in the forward, twice
    that under remat="block" (the checkpoint reruns each block's forward
    in the backward), the other kernel never, every glu_2d launch on
    tma_wgmma; finite losses, nothing skipped."""
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw as TA
    cfg, kernel = _smoke_deployment(dep)
    params = TM.materialize_params(cfg, seed=0, device=cuda)
    opt = TA.init_state(params)
    step = TS.make_train_step(cfg, TS.TrainHyper(
        remat=remat, opt=TA.AdamWConfig(lr_peak=1e-2, warmup_steps=2)))
    pipe = SyntheticPipeline(cfg, DataConfig(seed=1, vocab_size=512), 4, 16,
                             device=cuda)
    batches = [pipe(s) for s in (1, 2)]
    launches, variants = dict(tepi.LAUNCHES), dict(tepi.GLU_VARIANTS)
    for s, batch in zip((1, 2), batches):
        params, opt, m = step(params, opt, batch, s)
        assert np.isfinite(float(m["loss"])) and int(m["skipped"]) == 0
    got = {k: tepi.LAUNCHES[k] - launches[k] for k in launches}
    other = "elementwise_2d" if kernel == "glu_2d" else "glu_2d"
    assert got[kernel] == 2 * cfg.n_layers * per_layer, got
    assert got[other] == 0, got
    if kernel == "glu_2d":
        assert tepi.GLU_VARIANTS["tma_wgmma"] - variants["tma_wgmma"] \
            == got["glu_2d"]


@pytest.mark.parametrize("dep", ["fused", "kernel"])
def test_loss_grads_on_card_match_cpu(cuda, dep):
    """The gradient reaches every leaf through the kernels: f32 gradients
    of the loss on the card (kernels) against the CPU (plain versions) on
    the same weights and batch, within 1e-4 relative to each leaf's
    largest |grad|; the FFN weights and the act leaf among them."""
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg, _ = _smoke_deployment(dep, "float32")
    cpu_params = TM.materialize_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 17)).astype(np.int32))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), cpu_params)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        loss, _ = TM.loss_fn(p, batch, cfg, TS.make_engine(cfg), remat="none")
        leaves = tree_leaves(p)
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    for gc, gp in zip(grads["cuda"], grads["cpu"]):
        scale = float(gp.abs().max())
        assert scale > 0
        assert float((gc - gp).abs().max()) <= 1e-4 * scale


def test_table_lookup_backward_is_deterministic_and_sync_free(cuda):
    """The plain datapaths' table lookup at the training shape: the same
    gradient bits on every run, and neither direction makes the host wait
    (CUDA's sync debug mode raises on a sync)."""
    from repro_torch.core.catmull_rom import table_lookup
    gen = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((32, 4), generator=gen, device=cuda,
                        requires_grad=True)
    k = torch.randint(0, 32, (1000, 3072), generator=gen, device=cuda)
    g = torch.randn((1000, 3072, 4), generator=gen, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = [torch.autograd.grad(table_lookup(table, k), table, g)[0]
                 for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    ref, = torch.autograd.grad(table[k], table, g)
    assert float((grads[0] - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())


# --- the widths the dense and MoE archs give both kernels ---------------------

# the archs beyond qwen3-0.6b; glu_2d runs at (d_model, d_ff) on every fused
# FFN and on llama4's shared expert (mixtral's routed experts go through the
# engine), elementwise_2d at d_ff on every FFN or expert activation
ARCHS = ("olmo-1b", "qwen2.5-3b", "yi-34b", "mixtral-8x22b",
         "llama4-scout-17b-a16e")
# qwen2-vl-2b (K 1536, N 8960) and hymba-1.5b (K 1600, N 5504) fuse their
# gated FFNs too
GLU_ARCHS = tuple(a for a in ARCHS if a != "mixtral-8x22b") + (
    "qwen2-vl-2b", "hymba-1.5b")
# Mamba's engine calls at d_inner, in f32: silu of the gate z and softplus
# of dt; decode (2 rows) of falcon-mamba-7b (8192) and the longest served
# prompt (100 rows) of hymba-1.5b (3200)
MAMBA_SHAPES = ((2, 8192), (100, 3200))


def _widths(arch):
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    return cfg.d_model, cfg.d_ff


def _engine_rows(slots=2, max_prompt=128):
    """Every row count a served forward with ``slots`` slots hands the FFN
    kernels: decode (``slots`` rows) and a prefill of 1 to ``slots``
    prompts padded to one power-of-two bucket, from the engine's smallest
    (``EngineConfig.min_bucket``) to ``max_prompt``. MoE expert tensors
    stay within the largest (gshard: E x groups x C; ragged: tokens x
    top-k)."""
    from repro_torch.serve import EngineConfig
    b, buckets = EngineConfig().min_bucket, []
    while b <= max_prompt:
        buckets.append(b)
        b *= 2
    return sorted({slots} | {n * b for n in range(1, slots + 1)
                             for b in buckets})


@pytest.mark.parametrize("arch", GLU_ARCHS)
@pytest.mark.parametrize("scheme", ("cr_spline",) + SCHEMES)
def test_glu_kernel_at_arch_shapes(cuda, scheme, arch):
    """glu_2d at each arch's (K, N), at every served row count: the TMA +
    wgmma variant, the plain version's numbers, the same bits again."""
    k, n = _widths(arch)
    spec, p = _any_scheme(scheme, "silu", cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    wg, wu = ((torch.rand((k, n), generator=gen, device=cuda) - 0.5)
              .mul_(0.1).to(torch.bfloat16) for _ in range(2))
    for m in _engine_rows():
        x = (torch.rand((m, k), generator=gen, device=cuda) * 2 - 1).to(
            torch.bfloat16)
        n0 = tepi.GLU_VARIANTS["tma_wgmma"]
        y = tepi.glu_2d(x, wg, wu, p, spec=spec)
        torch.cuda.synchronize()
        assert tepi.GLU_VARIANTS["tma_wgmma"] == n0 + 1, (m, k, n)
        torch.testing.assert_close(
            y.float(), tepi.glu_2d_plain(x, wg, wu, p, spec=spec).float(),
            rtol=1e-2, atol=1e-3)
        assert torch.equal(tepi.glu_2d(x, wg, wu, p, spec=spec), y)


def test_glu_kernel_on_layer_stacked_weights(cuda):
    """The served path hands glu_2d views into the layer-stacked [L, d, f]
    weights (and a MoE layer's shared expert): every layer's view is
    TMA-addressable and gives its own layer's product."""
    spec, p = _table("silu", cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    stack = (torch.randn((3, 2, 512, 1024), generator=gen, device=cuda)
             * 0.05).to(torch.bfloat16)
    x = torch.randn((2, 512), generator=gen, device=cuda).to(torch.bfloat16)
    for i in range(3):
        wg, wu = stack[i, 0], stack[i, 1]
        n0 = tepi.GLU_VARIANTS["tma_wgmma"]
        y = tepi.glu_2d(x, wg, wu, p, spec=spec)
        assert tepi.GLU_VARIANTS["tma_wgmma"] == n0 + 1, i
        torch.testing.assert_close(
            y.float(), tepi.glu_2d_plain(x, wg, wu, p, spec=spec).float(),
            rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ("cr_spline",) + SCHEMES)
def test_elementwise_kernel_at_arch_shapes(cuda, scheme, dtype):
    """elementwise_2d at every arch's d_ff, at every served row count."""
    dt = getattr(torch, dtype)
    spec, p = _any_scheme(scheme, "silu", cuda)
    for cols in sorted({_widths(a)[1] for a in ARCHS}):
        for rows in _engine_rows():
            x = torch.from_numpy(rand((rows, cols), seed=rows)).to(cuda, dt)
            _check_elementwise(spec, p, "silu", x)


@pytest.mark.parametrize("shape", MAMBA_SHAPES)
@pytest.mark.parametrize("scheme,act", [
    (s, a) for s in ("cr_spline",) + SCHEMES for a in ("silu", "softplus")
    if (s, a) != ("rational", "softplus")])
def test_elementwise_kernel_at_mamba_shapes(cuda, scheme, act, shape):
    """elementwise_2d on f32 inputs at Mamba's widths, every scheme that
    has the epilogue (rational has no softplus): bitwise the plain
    version, the same bits again."""
    spec, p = _any_scheme(scheme, act, cuda)
    x = torch.from_numpy(rand(shape, seed=shape[0])).to(cuda)
    _check_elementwise(spec, p, act, x)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_mamba_block_on_card_matches_cpu(cuda, arch):
    """One kernelized Mamba-carrying block (f32) on the card against the
    CPU on the same params: output and the carried conv / ssm state
    within 1e-5 relative, three elementwise_2d launches for the Mamba
    branch; at bf16 a decode-shaped step makes no host sync."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.common import act_impl_of
    from repro_torch.core.activations import ActivationEngine, init_act_params
    from repro_torch.models import layers as TL
    cfg = act_impl_of(registry.get(arch, smoke=True, compute_dtype="float32"),
                      "cr_spline", use_kernel=True)
    layer_cfgs = cfg.layer_activation_configs()
    eng_on = {dev: ActivationEngine(layer_cfgs[0]).bind(
        {t: torch.as_tensor(a, device=dev)
         for t, a in init_act_params(layer_cfgs).items()})
        for dev in ("cpu", "cuda")}
    params = TL.init_mamba(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.5
    want = TL.apply_mamba(params, x, cfg, eng_on["cpu"])
    on = {k: v.to(cuda) for k, v in params.items()}
    n0 = tepi.LAUNCHES["elementwise_2d"]
    got = TL.apply_mamba(on, x.to(cuda), cfg, eng_on["cuda"])
    torch.cuda.synchronize()
    assert tepi.LAUNCHES["elementwise_2d"] - n0 == 3
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * scale
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    onb = {k: v.to(torch.bfloat16) if k in ("in_proj", "conv_w", "conv_b",
                                            "x_proj", "dt_proj_w",
                                            "out_proj") else v
           for k, v in on.items()}
    xd = x[:, :1].to(cuda, torch.bfloat16)
    _, cs, ss = TL.apply_mamba(onb, xd, bf, eng_on["cuda"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TL.apply_mamba(onb, xd, bf, eng_on["cuda"], cs, ss)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch,impl", [
    ("mixtral-8x22b", "gshard"), ("mixtral-8x22b", "ragged"),
    ("llama4-scout-17b-a16e", "gshard"), ("llama4-scout-17b-a16e", "ragged")])
def test_moe_layer_on_card_matches_cpu(cuda, arch, impl):
    """One MoE layer (kernelized engine, f32) on the card against the CPU
    on the same params and input: outputs and aux within 1e-5 relative;
    at bf16 the card's decode-shaped call makes no host sync."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.common import act_impl_of
    from repro_torch.core.activations import ActivationEngine, init_act_params
    from repro_torch.models import layers as TL
    cfg = act_impl_of(registry.get(arch, smoke=True, moe_impl=impl,
                                   compute_dtype="float32"),
                      "cr_spline", use_kernel=True)
    layer_cfgs = cfg.layer_activation_configs()
    # bound to the act leaf on each device, as the model binds it: an
    # unbound engine copies the registry's params to the card at each call
    eng_on = {dev: ActivationEngine(layer_cfgs[0]).bind(
        {t: torch.as_tensor(a, device=dev)
         for t, a in init_act_params(layer_cfgs).items()})
        for dev in ("cpu", "cuda")}
    params = TL.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.5
    y_cpu, aux_cpu = TL.apply_moe(params, x, cfg, eng_on["cpu"])
    eng = eng_on["cuda"]
    on = {k: (v.to(cuda) if torch.is_tensor(v) else
              {kk: vv.to(cuda) for kk, vv in v.items()})
          for k, v in params.items()}
    n0 = tepi.LAUNCHES["elementwise_2d"]
    y, aux = TL.apply_moe(on, x.to(cuda), cfg, eng)
    torch.cuda.synchronize()
    assert tepi.LAUNCHES["elementwise_2d"] > n0
    scale = float(y_cpu.abs().max())
    assert float((y.cpu() - y_cpu).abs().max()) <= 1e-5 * scale
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5 * abs(float(aux_cpu))
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    onb = {k: (v.to(torch.bfloat16) if torch.is_tensor(v) else
               {kk: vv.to(torch.bfloat16) for kk, vv in v.items()})
           for k, v in on.items()}
    xd = x[:, :1].to(cuda, torch.bfloat16)
    TL.apply_moe(onb, xd, bf, eng)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TL.apply_moe(onb, xd, bf, eng)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_mixed_assignment_logits_on_card_match_cpu(cuda):
    """A per-layer assignment, fused (each layer's glu_2d launch reads its
    own scheme's params), f32: logits on the card within 1e-4 relative of
    the CPU's, and glu_2d launched once a layer."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.common import act_layers_of
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM
    base = registry.get("qwen3-0.6b", smoke=True, n_layers=4,
                        compute_dtype="float32")
    cfg = dataclasses.replace(act_layers_of(
        base, ("cr-d32", "pwl-d16", "poly-d8-g3", "rational-d32-g5"),
        use_kernel=True), fuse_mlp=True)
    params = TM.materialize_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 19)).astype(np.int32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = TM.compute_params(TM.params_from_numpy(
            _np_tree(params), cfg, device=dev), cfg)
        n0 = tepi.LAUNCHES["glu_2d"]
        out[dev.type] = TM.forward_fn(p, {"tokens": toks.to(dev)}, cfg,
                                      TS.make_engine(cfg)).cpu()
        if dev.type == "cuda":
            assert tepi.LAUNCHES["glu_2d"] - n0 == cfg.n_layers
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-4 * scale


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()
