"""Port vs reference: the epilogue ops and the activation engine.

On the CPU the port's wrappers run the kernels' plain versions; the
reference runs its Pallas kernels in interpret mode, as its own tests do.
The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_kernels_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.activations import ActivationConfig as JCfg  # noqa: E402
from repro.core.activations import ActivationEngine as JEng  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.activations import ActivationConfig as TCfg  # noqa: E402
from repro_torch.core.activations import ActivationEngine as TEng  # noqa: E402
from repro_torch.kernels import epilogue as tepi  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

EPILOGUES = ("tanh", "sigmoid", "silu", "gelu_tanh", "softplus")


def rand(shape, scale=6.0, seed=0):
    return np.random.RandomState(seed).uniform(-scale, scale, shape).astype(
        np.float32)


def bf16_ulp(ref):
    """One bf16 ulp at each |ref| (8 significant bits)."""
    a = np.maximum(np.abs(ref.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def assert_within_bf16_ulp(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(got - ref)
    assert np.all(err <= bf16_ulp(ref)), (err.max(), np.argmax(err))


@pytest.mark.parametrize("act", EPILOGUES)
@pytest.mark.parametrize("shape", [(37, 1000), (3, 5, 130), ()])
def test_act_matches_reference_f32(act, shape):
    x = rand(shape, seed=len(shape) + 7)
    yj = np.asarray(jops.act(jnp.asarray(x), act))
    yt = tops.act(torch.from_numpy(x), act)
    assert tuple(yt.shape) == shape and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("act", EPILOGUES)
@pytest.mark.parametrize("shape", [(37, 1000), (3, 5, 130)])
def test_act_matches_reference_bf16(act, shape):
    x = rand(shape, seed=len(shape))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    yj = jops.act(xj, act)
    yt = tops.act(xt, act)
    assert yt.dtype == torch.bfloat16
    assert_within_bf16_ulp(yt.float().numpy(), np.asarray(yj, np.float32))


@pytest.mark.parametrize("act", EPILOGUES)
def test_act_matches_oracle(act):
    x = torch.from_numpy(rand((8, 300), seed=3))
    table = tepi.table_for(act, 4.0, 32)
    np.testing.assert_allclose(tops.act(x, act).numpy(),
                               tref.act_ref(x, act, table).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_cr_act_is_tanh_instance():
    x = torch.from_numpy(rand((4, 256), seed=5))
    assert torch.equal(tops.cr_act(x), tops.act(x, "tanh"))


@pytest.mark.parametrize("act", EPILOGUES)
@pytest.mark.parametrize("mkn", [(8, 128, 128), (37, 300, 130)])
def test_fused_glu_matches_reference_f32(act, mkn):
    m, k, n = mkn
    x = rand((m, k), scale=1.0, seed=m + n)
    wg = rand((k, n), scale=0.05, seed=k)
    wu = rand((k, n), scale=0.05, seed=k + 1)
    yj = np.asarray(jops.fused_glu(jnp.asarray(x), jnp.asarray(wg),
                                   jnp.asarray(wu), act=act))
    yt = tops.fused_glu(torch.from_numpy(x), torch.from_numpy(wg),
                        torch.from_numpy(wu), act=act)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6)
    yr = tref.fused_glu_ref(torch.from_numpy(x), torch.from_numpy(wg),
                            torch.from_numpy(wu),
                            tepi.table_for(act, 4.0, 32), act=act)
    np.testing.assert_allclose(yt.numpy(), yr.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "tanh"])
def test_fused_glu_matches_reference_bf16(act):
    x = rand((2, 9, 256), scale=1.0, seed=21)
    wg = rand((256, 192), scale=0.1, seed=22)
    wu = rand((256, 192), scale=0.1, seed=23)
    bj = lambda a: jnp.asarray(a, jnp.bfloat16)
    bt = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    yj = np.asarray(jops.fused_glu(bj(x), bj(wg), bj(wu), act=act),
                    np.float32)
    yt = tops.fused_glu(bt(x), bt(wg), bt(wu), act=act)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == (2, 9, 192)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=2e-2, atol=1e-3)


def test_bound_params_override_windows():
    """``params=`` (the model's bound leaf) replaces the built table."""
    x = torch.from_numpy(rand((4, 64), seed=31))
    win = tepi.table_for("tanh", 4.0, 32).windows
    y0 = tops.act(x, "tanh")
    assert torch.equal(tops.act(x, "tanh", params=win), y0)
    y2 = tops.act(x, "tanh", params=2.0 * win)
    inside = x.abs() < 4.0
    torch.testing.assert_close(y2[inside], 2.0 * y0[inside])


@pytest.mark.parametrize("fn", EPILOGUES)
@pytest.mark.parametrize("impl,use_kernel", [("exact", False), ("cr", False),
                                             ("cr", True)])
def test_engine_matches_reference(fn, impl, use_kernel):
    x = rand((16, 384), seed=23)
    je = JEng(JCfg(impl=impl, use_kernel=use_kernel))
    te = TEng(TCfg(impl=impl, use_kernel=use_kernel))
    yj = np.asarray(getattr(je, fn)(jnp.asarray(x)))
    yt = getattr(te, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["silu", "tanh"])
def test_bound_engine_matches_reference(fn):
    cfg = dict(impl="cr", use_kernel=False)
    win = 1.5 * np.asarray(tepi.table_for("tanh", 4.0, 32).windows,
                           np.float32)
    x = rand((8, 128), seed=41)
    for use_kernel in (False, True):
        c = dict(cfg, use_kernel=use_kernel)
        je = JEng(JCfg(**c)).bind({"cr-d32": jnp.asarray(win)})
        te = TEng(TCfg(**c)).bind({"cr-d32": torch.from_numpy(win)})
        assert te.act_params is not None
        np.testing.assert_allclose(
            getattr(te, fn)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(je, fn)(jnp.asarray(x))), rtol=1e-5,
            atol=1e-6)


def test_engine_config_tags_round_trip():
    for c in (TCfg(), TCfg(impl="cr", depth=64), TCfg(impl="cr", int_bits=3,
                                                      frac_bits=12)):
        jc = JCfg(**dataclasses.asdict(c))
        assert c.tag() == jc.tag()
        assert TCfg.from_tag(c.tag()) == dataclasses.replace(c)


def test_engine_rejects_unported_impls():
    with pytest.raises(ValueError, match="unknown activation impl"):
        TEng(TCfg(impl="cordic"))
    with pytest.raises(ValueError, match="no kernel lowering"):
        TEng(TCfg(impl="cr_fixed", use_kernel=True))
    # the integer datapaths build, unkernelized (tests/test_torch_fixed_*)
    for impl in ("cr_fixed", "pwl_fixed", "poly_fixed", "rational_fixed"):
        eng = TEng(TCfg(impl=impl))
        assert eng.act_impl is None and not eng._kernelized
        assert float(eng.tanh(torch.tensor([0.5]))) == pytest.approx(
            float(np.tanh(0.5)), abs=2e-3)
    for impl in ("pwl", "poly", "rational", "region", "taylor", "base2"):
        TEng(TCfg(impl=impl))


def test_wrappers_take_the_plain_version_on_cpu():
    before = dict(tepi.LAUNCHES)
    x = torch.from_numpy(rand((4, 64), seed=1))
    tops.act(x, "silu")
    tops.fused_glu(x, torch.ones(64, 32), torch.ones(64, 32))
    assert tepi.LAUNCHES == before


# --- glu_2d's kernel variants ----------------------------------------------

@pytest.mark.parametrize("m", [2, 32, 64, 128, 256])
def test_glu_variant_serving_shapes_take_tma_wgmma(m):
    """Every decode and prefill row count of the served qwen3-0.6b FFN
    (K=1024, N=3072, bf16, fresh aligned tensors) takes the TMA kernel."""
    assert tepi._glu_variant(m, 3072, 1024, torch.bfloat16, True) \
        == "tma_wgmma"


@pytest.mark.parametrize("m,n,k,dtype,aligned,variant", [
    (2, 3072, 1024, torch.float32, True, "simt_f32"),
    (256, 3072, 1024, torch.float32, False, "simt_f32"),
    (2, 3001, 1024, torch.bfloat16, True, "wmma"),       # N % 8 != 0
    (2, 130, 1024, torch.bfloat16, True, "wmma"),
    (2, 3072, 1020, torch.bfloat16, True, "wmma"),       # x's row stride
    (2, 3072, 1024, torch.bfloat16, False, "wmma"),      # misaligned operand
    (65, 3000, 1000, torch.bfloat16, True, "tma_wgmma"),  # ragged, addressable
], ids=["f32", "f32-unaligned", "n3001", "n130", "k1020", "misaligned",
        "ragged-aligned"])
def test_glu_variant_by_type_and_addressability(m, n, k, dtype, aligned,
                                                variant):
    assert tepi._glu_variant(m, n, k, dtype, aligned) == variant


def test_glu_variant_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tepi._glu_variant(2, 3072, 1024, torch.float16, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(2, 64, 32), (65, 1000, 3000)])
def test_glu_cpu_call_runs_plain_and_counts_nothing(dtype, mkn):
    m, k, n = mkn
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rand((m, k), scale=1.0, seed=m)).to(dt)
    wg = torch.from_numpy(rand((k, n), scale=0.05, seed=k)).to(dt)
    wu = torch.from_numpy(rand((k, n), scale=0.05, seed=n)).to(dt)
    table = tepi.table_for("silu", 4.0, 32)
    spec = tepi.TableSpec.of(table)
    p = torch.as_tensor(table.windows, dtype=torch.float32)
    launches, variants = dict(tepi.LAUNCHES), dict(tepi.GLU_VARIANTS)
    y = tepi.glu_2d(x, wg, wu, p, spec=spec)
    assert tepi.LAUNCHES == launches and tepi.GLU_VARIANTS == variants
    assert torch.equal(y, tepi.glu_2d_plain(x, wg, wu, p, spec=spec))


# --- elementwise_2d's launch geometry ---------------------------------------

# csrc/elementwise.cu: its __launch_bounds__, and its elements per thread
# (one 16-byte vector)
_EW_MAX_THREADS = 256
_EW_EPT = {torch.float32: 4, torch.bfloat16: 8}


def _elementwise_walk(n, blocks, threads, ept):
    """How many times csrc/elementwise.cu's grid writes each of the n
    elements: thread g takes [g * ept, g * ept + ept), the ones below n.
    Also returns the elements it would have written past n."""
    first = np.arange(blocks * threads, dtype=np.int64) * ept
    idx = (first[:, None] + np.arange(ept, dtype=np.int64)).reshape(-1)
    return np.bincount(idx[idx < n], minlength=n), int((idx >= n).sum())


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [
    (1, 1), (1, 7), (1, 8), (1, 9), (2, 3072), (37, 1000), (128, 3072),
    (256, 3072), (1, 2 ** 16)])
def test_elementwise_geometry_covers_every_element_once(rows, cols, dtype,
                                                        aligned):
    dt = getattr(torch, dtype)
    n = rows * cols
    blocks, threads, ept = tepi._elementwise_geometry(rows, cols, dt,
                                                      aligned)
    # what the C side accepts: whole warps within the launch bound, its
    # ept, no block wholly past n
    assert threads % 32 == 0 and 32 <= threads <= _EW_MAX_THREADS
    assert ept == _EW_EPT[dt]
    assert blocks >= 1 and (blocks - 1) * threads * ept < n
    counts, past = _elementwise_walk(n, blocks, threads, ept)
    assert counts.min() == 1 and counts.max() == 1
    # every element past n belongs to the last block, masked by the kernel
    assert past == blocks * threads * ept - n < threads * ept


def test_elementwise_geometry_by_shape():
    """Decode spreads over more than the 3 blocks the first slice's kernel
    took, each thread on one 16-byte vector; alignment does not change the
    geometry; float16 has no kernel."""
    assert tepi._elementwise_geometry(2, 3072, torch.bfloat16, True) \
        == (6, 128, 8)
    assert tepi._elementwise_geometry(128, 3072, torch.bfloat16, True) \
        == (384, 128, 8)
    assert tepi._elementwise_geometry(256, 3072, torch.float32, True) \
        == (1536, 128, 4)
    for rows, cols in ((2, 3072), (128, 3072), (1, 9)):
        for dt in (torch.float32, torch.bfloat16):
            assert tepi._elementwise_geometry(rows, cols, dt, False) \
                == tepi._elementwise_geometry(rows, cols, dt, True)
    with pytest.raises(TypeError):
        tepi._elementwise_geometry(2, 3072, torch.float16, True)


# --- the pwl / poly / rational schemes -------------------------------------

# (scheme, geometry): the reference's representative geometry of each
# scheme and the deployment geometry of ActivationConfig (depth 32,
# degree 3)
SCHEME_GEOMS = [("pwl", dict(depth=32)), ("poly", dict(depth=8, degree=3)),
                ("poly", dict(depth=32, degree=3)),
                ("rational", dict(degree=5)), ("rational", dict(degree=3))]
SCHEME_ACTS = [(s, g, a) for s, g in SCHEME_GEOMS for a in EPILOGUES
               if (s, a) != ("rational", "softplus")]


def _sid(case):
    return "-".join(str(v) for v in (case[0], *case[1].values(), *case[2:]))


@pytest.mark.parametrize("case", SCHEME_ACTS, ids=_sid)
def test_scheme_act_matches_reference(case):
    scheme, geom, act = case
    x = rand((37, 1000), seed=13)
    yj = np.asarray(jops.act(jnp.asarray(x), act, method=scheme, **geom))
    yt = tops.act(torch.from_numpy(x), act, method=scheme, **geom)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == x.shape
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6)
    xb = rand((3, 5, 130), seed=14)
    yj = jops.act(jnp.asarray(xb, jnp.bfloat16), act, method=scheme, **geom)
    yt = tops.act(torch.from_numpy(xb).to(torch.bfloat16), act,
                  method=scheme, **geom)
    assert yt.dtype == torch.bfloat16
    assert_within_bf16_ulp(yt.float().numpy(), np.asarray(yj, np.float32))


@pytest.mark.parametrize("case", SCHEME_ACTS, ids=_sid)
def test_scheme_fused_glu_matches_reference(case):
    scheme, geom, act = case
    m, k, n = 37, 300, 130
    x = rand((m, k), scale=1.0, seed=51)
    wg = rand((k, n), scale=0.05, seed=52)
    wu = rand((k, n), scale=0.05, seed=53)
    yj = np.asarray(jops.fused_glu(jnp.asarray(x), jnp.asarray(wg),
                                   jnp.asarray(wu), act=act, method=scheme,
                                   **geom))
    yt = tops.fused_glu(torch.from_numpy(x), torch.from_numpy(wg),
                        torch.from_numpy(wu), act=act, method=scheme, **geom)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", EPILOGUES)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("impl", ["pwl", "poly", "rational"])
def test_scheme_engine_matches_reference(impl, use_kernel, fn):
    x = rand((16, 384), seed=29)
    c = dict(impl=impl, depth=16, degree=5, use_kernel=use_kernel)
    je, te = JEng(JCfg(**c)), TEng(TCfg(**c))
    assert te.act_impl == je.act_impl == impl
    if (impl, fn) == ("rational", "softplus"):
        for eng, arr in ((je, jnp.asarray(x)), (te, torch.from_numpy(x))):
            with pytest.raises(ValueError, match="tanh only"):
                eng.softplus(arr)
        return
    yj = np.asarray(getattr(je, fn)(jnp.asarray(x)))
    yt = getattr(te, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["pwl", "poly", "rational"])
def test_scheme_bound_engine_matches_reference(impl):
    """The generic bound branch: the scheme's block on the model's leaf
    (here the built params scaled by 1.5: rational's numerator row only,
    so that its Newton reciprocal still converges), not a CR table."""
    from repro_torch.core import approximant as tap
    c = dict(impl=impl, depth=32, degree=3)
    tag = TCfg(**c).tag()
    spec = tap.spec_for(impl, "tanh", depth=32, degree=3)
    p = tap.params_for(spec).copy()
    p[: 1 if impl == "rational" else None] *= 1.5
    x = rand((8, 128), seed=43)
    for use_kernel in (False, True):
        je = JEng(JCfg(**c, use_kernel=use_kernel)).bind(
            {tag: jnp.asarray(p)})
        te = TEng(TCfg(**c, use_kernel=use_kernel)).bind(
            {tag: torch.from_numpy(p)})
        assert te.act_params is not None
        for fn in ("tanh", "silu"):
            yt = getattr(te, fn)(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(
                yt, np.asarray(getattr(je, fn)(jnp.asarray(x))), rtol=1e-5,
                atol=1e-6)
        # the leaf is what runs: not the built params, not a CR table
        y0 = TEng(TCfg(**c, use_kernel=use_kernel)).tanh(torch.from_numpy(x))
        assert not np.allclose(te.tanh(torch.from_numpy(x)).numpy(),
                               y0.numpy())


def test_glu_phase_durations_from_stamps():
    """kernels/glu_phases.py turns the kernel's per-CTA %globaltimer
    stamps into phase durations: means over the CTAs that wrote stamps
    (rows of zeros are CTAs that did not exist), the span from the first
    start to the last end."""
    from repro_torch.kernels import glu_phases
    stamps = np.zeros((6, 8), np.uint64)
    stamps[0] = [1000, 1100, 1300, 2000, 2100, 2300, 2600, 2700]
    stamps[1] = [1040, 1200, 1380, 2100, 2200, 2400, 2800, 2900]
    got = glu_phases.phases_of(stamps)
    assert got["ctas"] == 2 and got["start_spread"] == 40.0
    assert got["span"] == 1900.0
    assert got["to_first_stage"] == 320.0           # (300 + 340) / 2
    assert got["k_loop"] == 1030.0                  # (1000 + 1060) / 2
    assert got["reduce_epilogue_store"] == 350.0    # (300 + 400) / 2
    assert got["cluster_barrier_2"] == 100.0
