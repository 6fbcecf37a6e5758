"""Port vs reference: the page pool and the paged model functions.

``PagePool`` is host Python ported whole: on the same seeded sequence of
operations both packages hand out the same pages, hold the same
refcounts, match the same chains and evict in the same order. The model
functions of the paged contract (paged decode with its write mask,
prefix-cached prefill, chunked prefill) are held against the
reference's on the same weights and the same random pool at f32 compute,
within the f32 tolerance of ``tests/test_torch_model.py`` (1e-4 on the
logits); pool pages and position rows must agree exactly where they are
integer, within the same tolerance where they are k/v.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.common import act_impl_of as j_act_impl_of  # noqa: E402
from repro.configs.common import fused_of as j_fused_of  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.paging import PagePool as JPagePool  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.paging import PagePool, SlotPages  # noqa: E402

TOL = 1e-4          # f32 logits, as tests/test_torch_model.py


# --- page pool ---------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_state(p):
    return (list(p.free), dict(p.ref), list(p.cached.items()),
            dict(p.registry), dict(p.key_of), p.reserved, p.pages_peak,
            p.in_use, p.available())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_matches_reference_on_seeded_ops(seed):
    """A random walk of alloc / reserve / alloc_reserved / unreserve /
    register / match / share / release on both pools: every return value
    and the whole state agree after every operation."""
    rng = np.random.RandomState(seed)
    ps = 3
    port, ref = PagePool(12, ps), JPagePool(12, ps)
    prompts = [list(rng.randint(0, 4, (n,))) for n in (9, 9, 12, 6, 7)]
    prompts[1][:6] = prompts[0][:6]            # shared leading pages
    held = []                                  # page lists with a ref
    for _ in range(300):
        op = rng.randint(7)
        if op == 0:
            n = int(rng.randint(0, 4))
            a, b = port.alloc(n), ref.alloc(n)
            assert a == b
            if a:
                held.append(a)
        elif op == 1:
            n = int(rng.randint(0, 3))
            assert port.reserve(n) == ref.reserve(n)
        elif op == 2 and port.reserved:
            n = int(rng.randint(1, port.reserved + 1))
            a, b = port.alloc_reserved(n), ref.alloc_reserved(n)
            assert a == b
            held.append(a)
        elif op == 3 and port.reserved:
            n = int(rng.randint(0, port.reserved + 1))
            port.unreserve(n)
            ref.unreserve(n)
        elif op == 4 and held:
            pages = held[int(rng.randint(len(held)))]
            toks = prompts[int(rng.randint(len(prompts)))]
            port.register(toks, pages)
            ref.register(toks, pages)
        elif op == 5:
            toks = prompts[int(rng.randint(len(prompts)))]
            limit = int(rng.randint(0, 5))
            m = port.match(toks, limit=limit)
            assert m == ref.match(toks, limit=limit)
            # pinning parked pages must not eat into reservations (the
            # engine sizes admission so it never does)
            if m and sum(q in port.cached for q in m) <= port.available():
                port.share(m)
                ref.share(m)
                held.append(m)
        elif op == 6 and held:
            pages = held.pop(int(rng.randint(len(held))))
            port.release(pages)
            ref.release(pages)
        assert _pool_state(port) == _pool_state(ref)


def test_page_pool_invariants():
    """The reference's own pool cases, on the port: the trash page is
    never handed out, reservations gate direct allocs, refcount-0
    registered pages park and revive, parked chains evict LRU-first only
    once the free list is dry."""
    p = PagePool(n_pages=6, page_size=4)
    a = p.alloc(5)
    assert a is not None and 0 not in a and p.alloc(1) is None
    p.release(a[:2])
    assert 0 not in p.alloc(2) and p.available() == 0

    p = PagePool(n_pages=8, page_size=4)
    assert p.reserve(5) and p.alloc(3) is None and p.alloc(2) is not None
    assert len(p.alloc_reserved(5)) == 5 and p.available() == 0
    assert not p.reserve(1)

    p = PagePool(n_pages=8, page_size=4)
    toks = list(range(12))
    a = p.alloc(3)
    p.register(toks, a)
    assert p.match(toks, limit=2) == a[:2]
    assert p.match([99] + toks[1:], limit=3) == []
    p.release(a)
    assert p.in_use == 0 and p.match(toks, limit=3) == a
    p.share(a)
    assert p.in_use == 3

    p = PagePool(n_pages=5, page_size=2)
    a, b = p.alloc(2), p.alloc(2)
    p.register([1, 2], a[:1])
    p.register([3, 4], b[:1])
    p.release(a)
    p.release(b)
    p.share(a[:1])                      # touch a -> b[0] is now LRU
    p.release(a[:1])
    p.alloc(3)                          # 2 free + 1 eviction (b[0])
    assert p.match([3, 4], limit=1) == []
    assert p.match([1, 2], limit=1) == a[:1]

    for bad in ((1, 4), (4, 0)):
        with pytest.raises(ValueError):
            PagePool(*bad)
    with pytest.raises(ValueError, match="unreserve"):
        PagePool(4, 2).unreserve(1)
    sp = SlotPages(pages=[3, 4], n_shared=1, worst=5)
    assert sp.prefill_done and not sp.first_chunk and sp.prefill_pos == 0


# --- the paged model functions ------------------------------------------------

def deployment(dep, scheme=None):
    jc = JR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    tc = TR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    if scheme is not None:
        jc, tc = j_act_impl_of(jc, scheme), act_impl_of(tc, scheme)
    if dep == "fused":
        jc, tc = j_fused_of(jc), fused_of(tc)
    elif dep == "kernel":
        jc = j_act_impl_of(jc, scheme or "cr_spline", use_kernel=True)
        tc = act_impl_of(tc, scheme or "cr_spline", use_kernel=True)
    jp, _ = JM.materialize_params(jc, seed=0)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


DEPS = [("plain", None), ("fused", None), ("kernel", None),
        ("fused", "pwl"), ("kernel", "rational")]


@pytest.fixture(scope="module", params=DEPS, ids=lambda d: "-".join(
    x for x in d if x))
def dep(request):
    return deployment(*request.param)


def _pool(cfg, n_pages, ps, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim_)
    return {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}


def test_paged_cache_layout_matches_reference():
    jc = JR.get("qwen3-0.6b", smoke=True)
    tc = TR.get("qwen3-0.6b", smoke=True)
    for seq_len, ps in ((40, 5), (40, 16), (33, 1), (20, 64)):
        assert TM.pages_per_slot(tc, seq_len, ps) == \
            JM.pages_per_slot(jc, seq_len, ps)
    tcache = TM.init_paged_cache(tc, 3, 11, 5, 40, device="cpu")
    jcache = JM.init_paged_cache(jc, 3, 11, 5, 40)
    for name in ("k", "v"):
        t, j = tcache["layers"][name], jcache["layers"][name]
        assert tuple(t.shape) == j.shape and not t.any()
        assert t.dtype == torch.bfloat16
    for name in ("cur", "k_pos", "page_tbl"):
        np.testing.assert_array_equal(tcache[name].numpy(),
                                      np.asarray(jcache[name]))
    sw = dataclasses.replace(tc, sliding_window=32)
    assert TM.pages_per_slot(sw, 100, 5) == 7


def test_paged_decode_logits_and_write_mask_match_reference(dep):
    """Two decode steps on a random pool: row 0 writes across a page
    boundary, row 1 is masked off in step 1 (its cache must come out as
    it went in), row 2 is a dead row whose table is all trash. Logits,
    pool, k_pos and cur agree with the reference."""
    jc, tc, jp, tp = dep
    ps, n = 4, 3                                     # W = 12
    pool = _pool(tc, 8, ps, 0)
    tbl = np.array([[3, 1, 6], [2, 5, 0], [0, 0, 0]], np.int32)
    k_pos = np.full((3, n * ps), -1, np.int32)
    k_pos[0, :7] = np.arange(7)
    k_pos[1, :5] = np.arange(5)
    cur = np.array([7, 5, 0], np.int32)
    jcache = {"layers": {k: jnp.asarray(v) for k, v in pool.items()},
              "cur": jnp.asarray(cur), "k_pos": jnp.asarray(k_pos),
              "page_tbl": jnp.asarray(tbl)}
    tcache = {"layers": {k: torch.from_numpy(v.copy())
                         for k, v in pool.items()},
              "cur": torch.from_numpy(cur.copy()),
              "k_pos": torch.from_numpy(k_pos.copy()),
              "page_tbl": torch.from_numpy(tbl.copy())}
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    toks = np.array([[5], [9], [1]], np.int32)
    for mask in ([True, False, False], [True, True, False]):
        wm = np.array(mask)
        jl, jcache = JM.decode_fn(jp, {"tokens": jnp.asarray(toks),
                                       "write_mask": jnp.asarray(wm)},
                                  jcache, jc, je)
        tl, tcache = TM.decode_fn(tp, {"tokens": torch.from_numpy(toks),
                                       "write_mask": torch.from_numpy(wm)},
                                  tcache, tc, te)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   rtol=0, atol=TOL)
        for name in ("cur", "k_pos", "page_tbl"):
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))
        for name in ("k", "v"):
            # page 0 is the trash page: its contents are undefined
            np.testing.assert_allclose(
                tcache["layers"][name][:, 1:].numpy(),
                np.asarray(jcache["layers"][name])[:, 1:], rtol=0, atol=TOL)
        if not mask[1]:
            # the masked row's pages and position row are untouched
            for name in ("k", "v"):
                np.testing.assert_array_equal(
                    tcache["layers"][name][:, [2, 5]].numpy(),
                    pool[name][:, [2, 5]])
            np.testing.assert_array_equal(tcache["k_pos"][1].numpy(),
                                          k_pos[1])
            assert int(tcache["cur"][1]) == 5
        toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]


def test_prefix_prefill_logits_match_reference(dep):
    """Ragged suffixes over a shared 2-page prefix gathered from a random
    pool: logits at the last real suffix token, suffix k/v (padded to
    whole pages), cur and k_pos agree with the reference."""
    jc, tc, jp, tp = dep
    ps, n_pre, capacity = 4, 2, 24
    pool = _pool(tc, 6, ps, 1)
    pages = [4, 2]
    prefix = {k: v[:, pages].reshape(v.shape[0], n_pre * ps, *v.shape[3:])
              for k, v in pool.items()}
    toks = np.random.RandomState(2).randint(0, 512, (2, 6)).astype(np.int32)
    lens = np.array([6, 3], np.int32)
    jl, jc_out = JM.prefill_prefix_fn(
        jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)}, jc,
        JS.make_engine(jc), {k: jnp.asarray(v) for k, v in prefix.items()},
        n_pre * ps, capacity, ps)
    tl, tc_out = TM.prefill_prefix_fn(
        tp, {"tokens": torch.from_numpy(toks),
             "lengths": torch.from_numpy(lens)}, tc, TS.make_engine(tc),
        {k: torch.from_numpy(v) for k, v in prefix.items()},
        n_pre * ps, capacity, ps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    for name in ("cur", "k_pos"):
        np.testing.assert_array_equal(tc_out[name].numpy(),
                                      np.asarray(jc_out[name]))
    for name in ("k", "v"):
        t, j = tc_out["layers"][name], np.asarray(jc_out["layers"][name])
        assert tuple(t.shape) == j.shape == (tc.n_layers, 2, 8,
                                             tc.n_kv_heads, tc.head_dim_)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_prefill_chunk_logits_match_reference(window):
    """Two chunks of one slot's prompt (5 then 4 tokens, padded to 8)
    over a 3-page ring of page size 4: the second crosses a page boundary
    and, under a 6-token sliding window, overwrites ring entries still in
    earlier queries' view. Logits, pool pages and the k_pos row agree."""
    jc, tc, jp, tp = deployment("fused")
    if window:
        jc = dataclasses.replace(jc, sliding_window=window)
        tc = dataclasses.replace(tc, sliding_window=window)
    ps = 4
    pool = _pool(tc, 6, ps, 3)
    tbl_row = np.array([5, 1, 3], np.int32)
    prompt = np.random.RandomState(4).randint(0, 512, (9,)).astype(np.int32)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    jrow = jnp.full((12,), -1, jnp.int32)
    trow = torch.full((12,), -1, dtype=torch.int32)
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    for pos, clen in ((0, 5), (5, 4)):
        padded = np.zeros((1, 8), np.int32)
        padded[0, :clen] = prompt[pos:pos + clen]
        jl, jpool, jrow = JM.prefill_chunk_fn(
            jp, {"tokens": jnp.asarray(padded)}, jc, je, jpool,
            jnp.asarray(tbl_row), jrow, jnp.int32(pos), jnp.int32(clen), ps)
        tl, trow = TM.prefill_chunk_fn(
            tp, {"tokens": torch.from_numpy(padded)}, tc, te, tpool,
            torch.from_numpy(tbl_row), trow, pos, clen, ps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tpool[name][:, 1:].numpy(), np.asarray(jpool[name])[:, 1:],
                rtol=0, atol=TOL)
    if window is None:
        np.testing.assert_array_equal(trow.numpy()[:9], np.arange(9))


def test_chunk_step_builder_runs_the_chunk_function():
    _, tc, _, tp = deployment("plain")
    step = TS.make_prefill_chunk_step(tc, 4)
    pool = {k: torch.from_numpy(v) for k, v in _pool(tc, 3, 4, 5).items()}
    toks = torch.tensor([[7, 8, 9, 0]], dtype=torch.int32)
    logits, row = step(tp, {"tokens": toks}, pool,
                       torch.tensor([2, 1], dtype=torch.int32),
                       torch.full((8,), -1, dtype=torch.int32), 0, 3)
    assert tuple(logits.shape) == (1, tc.padded_vocab)
    assert row.tolist() == [0, 1, 2] + [-1] * 5
