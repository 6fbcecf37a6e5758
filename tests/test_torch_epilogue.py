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
    (2, 3072, 1024, torch.float32, True, "tma_f32"),
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


@pytest.mark.parametrize("m,n,k,aligned,variant", [
    (2, 3072, 1022, True, "simt_f32"),     # K % 4: x's row stride
    (2, 3002, 1024, True, "simt_f32"),     # N % 4: the weights' row stride
    (3, 3001, 1024, True, "simt_f32"),     # chip_smoke's unaddressable case
    (2, 3072, 1024, False, "simt_f32"),    # an unaligned base
    (2, 3072, 1020, True, "tma_f32"),      # K % 8 != 0 but K % 4 == 0
    (2, 130, 1024, True, "simt_f32"),
    (2, 132, 1024, True, "tma_f32"),
    (65, 3000, 1000, True, "tma_f32"),     # ragged, addressable
    (1024, 3072, 1024, True, "tma_f32"),
], ids=["k1022", "n3002", "n3001", "unaligned", "k1020", "n130", "n132",
        "ragged-aligned", "train"])
def test_glu_f32_variant_by_addressability(m, n, k, aligned, variant):
    """f32 takes tma_f32 wherever TMA can address the operands: 16-byte
    aligned bases and row strides of whole 16 bytes (K % 4, N % 4); every
    other f32 launch takes simt_f32."""
    assert tepi._glu_variant(m, n, k, torch.float32, aligned) == variant


# the trained FFNs' (K, N): qwen3-0.6b's, olmo-1b's, llama4's shared
# expert's and yi-34b's, the narrowest and the widest
_QWEN3_KN, _YI_KN = (1024, 3072), (7168, 20480)
_OLMO_KN, _LLAMA4_KN = (2048, 8192), (5120, 8192)


@pytest.mark.parametrize("kn", [_QWEN3_KN, _YI_KN, _OLMO_KN, _LLAMA4_KN,
                                (2056, 3072)],
                         ids=["qwen3", "yi34b", "olmo1b", "llama4", "k2056"])
@pytest.mark.parametrize("m", [256, 257, 511, 512, 1000, 1024, 4096])
def test_glu_variant_by_rows(m, kn):
    """bf16 that TMA can address takes the GEMM tile from GLU_GEMM_ROWS
    (512, the cap of the sweep's crossover: every served launch, at most
    256 rows, stays on tma_wgmma) at K up to GLU_GEMM_MAX_K (2048: qwen3
    and olmo-1b), and tma_wgmma below those rows or past that K (llama4's
    shared expert and yi-34b, where the sweep measured it faster, and K =
    2056, just past the limit)."""
    k, n = kn
    want = "tma_wgmma_gemm" if m >= 512 and k <= 2048 else "tma_wgmma"
    assert (tepi.GLU_GEMM_ROWS, tepi.GLU_GEMM_MAX_K) == (512, 2048)
    assert tepi._glu_variant(m, n, k, torch.bfloat16, True) == want


@pytest.mark.parametrize("m", [2, 256, 512, 1024, 4096])
@pytest.mark.parametrize("n,k,aligned", [(3001, 1024, True),
                                         (3072, 1020, True),
                                         (3072, 1024, False)],
                         ids=["n3001", "k1020", "misaligned"])
def test_glu_variant_unaddressable_bf16_takes_wmma_at_every_m(m, n, k,
                                                              aligned):
    assert tepi._glu_variant(m, n, k, torch.bfloat16, aligned) == "wmma"


@pytest.mark.parametrize("m", [512, 1024, 4096])
def test_glu_variant_f32_ignores_the_bf16_crossover(m):
    assert tepi._glu_variant(m, 3072, 1024, torch.float32, True) == "tma_f32"
    assert tepi._glu_variant(m, 3001, 1024, torch.float32, True) \
        == "simt_f32"


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


# --- glu_2d's f32 launch geometry (tma_f32) ---------------------------------

# the f32 shapes the main path launches glu_2d at (M, K, N): qwen3-0.6b's
# full-width FFN at every timed row count, its TP 2 / 4 decode shards,
# qwen2.5-3b's TP 4 and hymba's TP 2 shards, the sharded-train shards, the
# f32 checks against the CPU (1 x 32 tokens, a 2 x 40 ragged prefill)
_F32_SHAPES = [(2, 1024, 3072), (128, 1024, 3072), (256, 1024, 3072),
               (1024, 1024, 3072), (2, 1024, 1536), (2, 1024, 768),
               (128, 1024, 1536), (2, 2048, 2752), (128, 2048, 2752),
               (2, 1600, 2752), (100, 1600, 2752), (64, 1024, 1536),
               (32, 1024, 3072), (128, 1024, 768), (64, 1600, 2752),
               (32, 1024, 3072), (80, 1024, 3072), (1, 1024, 3072),
               (65, 1000, 3000), (2, 64, 32), (3, 4, 4), (1000, 1024, 3072)]
# the decode shapes chip_smoke.py times at f32 (M = 2)
_F32_DECODE = [(2, 1024, 3072), (2, 1024, 1536), (2, 1024, 768),
               (2, 2048, 2752), (2, 1600, 2752)]


def _f32_k_blocks_walk(k, bk, split):
    """How many ranks of a cluster of ``split`` take each of the K blocks
    (``bk`` rows each) of csrc/epilogue.cu's tma_f32 kernel: rank r takes
    blocks [r * kb // split, (r + 1) * kb // split)."""
    kb = -(-k // bk)
    seen = np.zeros(kb, dtype=np.int64)
    for r in range(split):
        seen[r * kb // split:(r + 1) * kb // split] += 1
    return seen


@pytest.mark.parametrize("mkn", _F32_SHAPES, ids=lambda s: "x".join(map(
    str, s)))
def test_glu_f32_geometry_covers_every_k_block_once(mkn):
    """Every K block of every tile is summed by exactly one rank of its
    cluster, each rank has at least one, the cluster is a portable one
    (1-8, what the C side takes), and the tiles cover M and N."""
    m, k, n = mkn
    bm, bn, bk, n_tiles, m_tiles, split = tepi._glu_f32_geometry(m, n, k)
    assert (bm, bn, bk) in {t[1:4] for t in tepi._F32_TILES}
    assert split in (1, 2, 4, 8) and split <= -(-k // bk)
    seen = _f32_k_blocks_walk(k, bk, split)
    assert (seen == 1).all()
    kb = len(seen)
    assert min((r + 1) * kb // split - r * kb // split
               for r in range(split)) >= 1
    assert n_tiles * bn >= n > (n_tiles - 1) * bn
    assert m_tiles * bm >= m > (m_tiles - 1) * bm


@pytest.mark.parametrize("mkn", _F32_DECODE, ids=lambda s: "x".join(map(
    str, s)))
def test_glu_f32_geometry_fills_the_card_at_decode(mkn):
    """At every timed decode shape the launch has at least one CTA for each
    of the H100's 132 SMs (the first slice's kernel ran 12-48 there), all
    of them resident at once."""
    m, k, n = mkn
    bm, bn, bk, n_tiles, m_tiles, split = tepi._glu_f32_geometry(m, n, k)
    ctas = n_tiles * m_tiles * split
    assert bm == 8 and ctas >= 132
    blocks = next(t[4] for t in tepi._F32_TILES if t[1] == bm)
    assert ctas <= blocks * 132


def test_glu_f32_geometry_by_shape():
    """The tile follows M (8 rows at decode, 32, then 64-row M tiles). The
    split of the bytes-bound tiles stops at one CTA for each SM; that of
    the 64-row tile fills the three CTAs an SM holds; a short K caps it."""
    assert tepi._glu_f32_geometry(2, 3072, 1024) == (8, 32, 32, 96, 1, 2)
    assert tepi._glu_f32_geometry(2, 768, 1024) == (8, 32, 32, 24, 1, 8)
    assert tepi._glu_f32_geometry(32, 3072, 1024) == (32, 64, 16, 48, 1, 4)
    assert tepi._glu_f32_geometry(64, 1536, 1024) == (64, 64, 16, 24, 1, 8)
    assert tepi._glu_f32_geometry(128, 2752, 2048) == (64, 64, 16, 43, 2, 4)
    assert tepi._glu_f32_geometry(256, 3072, 1024) == (64, 64, 16, 48, 4, 2)
    assert tepi._glu_f32_geometry(1024, 3072, 1024) == (64, 64, 16, 48, 16,
                                                         1)
    # a short K caps the split at its blocks
    assert tepi._glu_f32_geometry(2, 32, 64)[-1] == 2
    assert tepi._glu_f32_geometry(3, 4, 4)[-1] == 1


# --- glu_2d's bf16 train-step geometry (tma_wgmma_gemm) ----------------------

# (M, K, N) of tma_wgmma_gemm's launches: qwen3-0.6b's train
# step, the train runs' FFN shapes (olmo-1b, the qwen2.5-3b width; llama4's
# shared expert and yi-34b, past GLU_GEMM_MAX_K, take tma_wgmma, and the
# geometry still covers them), a sharded qwen3 rank, the card tests'
# ragged shapes and a short K
_GEMM_SHAPES = [(1024, 1024, 3072), (1024, 2048, 8192), (1024, 2048, 11008),
                (1024, 5120, 8192), (1024, 7168, 20480), (512, 1024, 1536),
                (257, 1000, 3000), (300, 936, 1536), (1000, 1000, 3000),
                (300, 64, 72), (4096, 1024, 3072), (384, 1024, 3072)]


def _gemm_k_blocks(kb, split):
    """How many warpgroups sum each of a tile's kb K blocks: split 1, one
    warpgroup all of them; split 2, the first takes [0, kb // 2), the
    second the rest (csrc/epilogue.cu repro_glu_bf16_gemm_kernel)."""
    seen = np.zeros(kb, dtype=np.int64)
    if split == 1:
        seen += 1
    else:
        seen[:kb // 2] += 1
        seen[kb // 2:] += 1
    return seen


@pytest.mark.parametrize("mkn", _GEMM_SHAPES, ids=lambda s: "x".join(map(
    str, s)))
def test_glu_bf16_geometry_covers_every_tile_and_k_block_once(mkn):
    """The tiles cover M and N, every CTA has a tile (split 2: one each)
    and every warpgroup that sums K has K blocks to sum; every K block of
    a tile is summed once; the split is 1 or 2 and never past the K
    blocks; the CTAs fit the card at once (one an SM)."""
    m, k, n = mkn
    bm, bn, bk, n_tiles, m_tiles, ctas, split = tepi._glu_bf16_geometry(
        m, n, k)
    assert (bm, bn, bk) == tepi._GEMM_TILE == (128, 64, 64)
    assert n_tiles * bn >= n > (n_tiles - 1) * bn
    assert m_tiles * bm >= m > (m_tiles - 1) * bm
    tiles, kb = n_tiles * m_tiles, -(-k // bk)
    assert split in (1, 2) and split <= kb
    assert 1 <= ctas <= min(tiles, 132)
    assert (_gemm_k_blocks(kb, split) == 1).all()
    if split == 2:
        assert ctas == tiles and kb // 2 >= 1    # one tile a CTA
    else:
        assert ctas == min(tiles, 132)


def test_glu_bf16_geometry_by_shape():
    """Tiles and CTAs at the shapes of PERF.md's bf16 train rows: 128 x 64
    tiles, a persistent walk of 132 CTAs (qwen3 M = 1024: 384 tiles, 2.91
    a CTA, two warpgroups each), split 2 where the tiles do not outnumber
    the SMs (a sharded qwen3 rank: 96 tiles, 96 CTAs) and K has two
    blocks."""
    g = tepi._glu_bf16_geometry
    assert g(1024, 3072, 1024) == (128, 64, 64, 48, 8, 132, 1)
    assert g(1024, 8192, 2048) == (128, 64, 64, 128, 8, 132, 1)
    assert g(1024, 11008, 2048) == (128, 64, 64, 172, 8, 132, 1)
    assert g(1024, 8192, 5120) == (128, 64, 64, 128, 8, 132, 1)
    assert g(1024, 20480, 7168) == (128, 64, 64, 320, 8, 132, 1)
    assert g(512, 1536, 1024) == (128, 64, 64, 24, 4, 96, 2)
    # tiles per CTA (waves of two warpgroups' tiles)
    assert 48 * 8 / 132 == pytest.approx(2.909, abs=1e-3)
    # one K block: no split, however few the tiles
    assert g(300, 72, 64) == (128, 64, 64, 2, 3, 6, 1)
    # 136 tiles: the walk, four CTAs taking two
    assert g(1024, 17 * 64, 1024)[3:] == (17, 8, 132, 1)


class _FakeGluLib:
    """Stands in for the kernel library on the CPU: records each
    repro_glu_2d call's (M, N, K, variant id, split) and returns 1
    (cudaErrorInvalidValue) where ``refuse`` says the C side would."""

    def __init__(self, refuse):
        self.refuse, self.calls = refuse, []

    def repro_glu_2d(self, *a):
        m, n, k, variant, split = a[5], a[6], a[7], a[-3], a[-2]
        self.calls.append((m, n, k, variant, split))
        return 1 if self.refuse(m, n, k, variant, split) else 0


def _gemm_refuses(m, n, k, variant, split):
    """csrc/epilogue.cu launch_glu_gemm's rule: split 1, or 2 with at most
    132 tiles and two K blocks; repro_glu_2d's for tma_wgmma: split 0."""
    if variant == tepi._GLU_VARIANT_IDS["tma_wgmma"]:
        return split != 0
    tiles, kb = -(-m // 128) * -(-n // 64), -(-k // 64)
    return not (split == 1 or (split == 2 and tiles <= 132 and kb >= 2))


def _gemm_call(m, k, n):
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    w = torch.zeros((k, n), dtype=torch.bfloat16)
    table = tepi.table_for("silu", 4.0, 32)
    spec = tepi.TableSpec.of(table)
    p = torch.as_tensor(table.windows, dtype=torch.float32)
    out = torch.empty((m, n), dtype=torch.bfloat16)
    return x, w, w, p, out, tepi._kernel_args("silu", spec, p, x), 0


@pytest.mark.parametrize("mkn", [(1024, 1024, 3072), (512, 1024, 1536),
                                 (1024, 7168, 20480)],
                         ids=["qwen3", "sharded", "yi34b"])
def test_glu_launch_passes_the_bf16_geometry(mkn):
    """The wrapper's launch hands the C side the variant id and the split
    of _glu_bf16_geometry (tma_wgmma, past GLU_GEMM_MAX_K: split 0), and
    counts the launch once it is taken."""
    m, k, n = mkn
    lib = _FakeGluLib(_gemm_refuses)
    launches, variants = dict(tepi.LAUNCHES), dict(tepi.GLU_VARIANTS)
    want = "tma_wgmma_gemm" if k <= 2048 else "tma_wgmma"
    try:
        got = tepi._launch_glu(lib, *_gemm_call(m, k, n))
        assert got == want
        assert lib.calls == [(m, n, k, tepi._GLU_VARIANT_IDS[want],
                              tepi._glu_bf16_geometry(m, n, k)[-1]
                              if want == "tma_wgmma_gemm" else 0)]
        assert tepi.LAUNCHES["glu_2d"] == launches["glu_2d"] + 1
        assert tepi.GLU_VARIANTS[want] == variants[want] + 1
    finally:
        tepi.LAUNCHES.update(launches)
        tepi.GLU_VARIANTS.update(variants)


@pytest.mark.parametrize("split,mkn", [(3, (1024, 1024, 3072)),
                                       (0, (1024, 1024, 3072)),
                                       (2, (1024, 1024, 3072)),
                                       (2, (512, 64, 1536))],
                         ids=["split3", "split0", "split2-384-tiles",
                              "split2-one-k-block"])
def test_glu_launch_raises_when_the_geometry_is_refused(monkeypatch, split,
                                                        mkn):
    """A geometry the C side refuses (a split other than 1 and 2, split 2
    past 132 tiles or under two K blocks) raises in the wrapper, which
    counts nothing and tries nothing else."""
    m, k, n = mkn
    geometry = tepi._glu_bf16_geometry
    monkeypatch.setattr(tepi, "_glu_bf16_geometry",
                        lambda *a: geometry(*a)[:-1] + (split,))
    lib = _FakeGluLib(_gemm_refuses)
    launches, variants = dict(tepi.LAUNCHES), dict(tepi.GLU_VARIANTS)
    with pytest.raises(RuntimeError, match=r"tma_wgmma_gemm, split"):
        tepi._launch_glu(lib, *_gemm_call(m, k, n))
    assert len(lib.calls) == 1
    assert tepi.LAUNCHES == launches and tepi.GLU_VARIANTS == variants


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


@pytest.mark.parametrize("wins,want", [
    ((0, 0, 0, 0, 1), 512),   # only M = 1024: kept to 512
    ((0, 0, 0, 1, 1), 512),
    ((0, 1, 0, 1, 1), 512),   # a loss at 384 resets it
    ((0, 0, 1, 1, 1), 384),
    ((0, 1, 1, 1, 1), 256),
    ((1, 1, 1, 1, 1), 256),   # kept above 128: M <= 128 stays on tma_wgmma
    ((0, 0, 0, 0, 0), 512),   # faster nowhere
])
def test_glu_bf16_crossover_from_the_sweep(wins, want):
    """kernels/glu_phases.py's crossover: the lowest swept M from which
    tma_wgmma_gemm is faster than tma_wgmma at every swept M, kept to the
    swept M within (128, 512]."""
    from repro_torch.kernels import glu_phases
    sweep = [{"shape": [m, 1024, 3072],
              "events_ms": {"tma_wgmma": 1.0,
                            "tma_wgmma_gemm": 0.5 if win else 1.5}}
             for m, win in zip(glu_phases.BF16_SWEEP_ROWS, wins)]
    assert glu_phases.crossover(sweep) == want


@pytest.mark.parametrize("wins,want", [
    ((0, 0, 0, 0, 1), 1024),
    ((0, 1, 0, 1, 1), 512),
    ((1, 1, 1, 1, 1), 128),   # uncapped: the lowest swept M
    ((0, 0, 0, 0, 0), None),
])
def test_glu_bf16_uncapped_crossover_from_the_sweep(wins, want):
    """The crossover as measured, before the cap to (128, 512]."""
    from repro_torch.kernels import glu_phases
    sweep = [{"shape": [m, 1024, 3072],
              "events_ms": {"tma_wgmma": 1.0,
                            "tma_wgmma_gemm": 0.5 if win else 1.5}}
             for m, win in zip(glu_phases.BF16_SWEEP_ROWS, wins)]
    assert glu_phases.crossover(sweep, capped=False) == want


@pytest.mark.parametrize("wins,want", [
    ((1, 1, 1, 1, 0, 0), 4096),
    ((1, 0, 0, 0, 0, 0), 1024),
    ((1, 1, 0, 1, 0, 0), 2048),   # a loss at 3072 ends it
    ((1, 1, 1, 1, 1, 1), 7168),
    ((0, 1, 1, 1, 1, 1), None),
])
def test_glu_bf16_k_sweep_reading(wins, want):
    """glu_phases' K sweep: the largest swept K up to which
    tma_wgmma_gemm is faster than tma_wgmma at every swept K."""
    from repro_torch.kernels import glu_phases
    sweep = [{"shape": [1024, k, 8192],
              "events_ms": {"tma_wgmma": 1.0,
                            "tma_wgmma_gemm": 0.5 if win else 1.5}}
             for k, win in zip(glu_phases.BF16_K_SWEEP_K, wins)]
    assert glu_phases.gemm_faster_to_k(sweep) == want


def test_glu_gemm_phase_durations_from_stamps():
    """glu_phases reads tma_wgmma_gemm's stamps by the tile's place in its
    CTA's walk: means over the CTAs that ran that many tiles."""
    from repro_torch.kernels import glu_phases
    stamps = np.zeros((3, glu_phases.GEMM_SLOTS), np.uint64)
    stamps[0, :3] = [1000, 1500, 9000]
    stamps[0, 3:12] = [1200, 3000, 4000, 3100, 5000, 6000, 4100, 7000, 8000]
    stamps[1, :3] = [1100, 1400, 6000]
    stamps[1, 3:9] = [1300, 3100, 4100, 3200, 5100, 5900]
    got = glu_phases.gemm_phases_of(stamps)
    assert got["ctas"] == 2 and got["span"] == 8000.0
    assert [t["ctas"] for t in got["tiles"]] == [2, 2, 1]
    assert got["tiles"][0]["wait_first_stage"] == 200.0   # from the start
    assert got["tiles"][0]["k_loop"] == 1800.0
    assert got["tiles"][2]["wait_first_stage"] == 100.0   # from tile 0's end
    assert got["tiles"][2]["epilogue"] == 1000.0


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
