"""Port vs reference: serving on the paged KV cache, with prefix reuse.

Both packages serve the same requests on the same (reference) weights at
f32 compute through ``EngineConfig(cache="paged")``, the default of
both; greedy tokens must be identical, request by request, to the
reference's paged engine and to the port's own slot path. Page sizes 5
(divides neither the ring nor the buckets), 1 and 64 (one page per
slot); a sliding-window variant whose ring wraps past page boundaries;
prefix hits under serial and batched admission; a pool too small for
two requests at once; a trash page filled with a large finite value;
fused and kernelized deployments under non-CR schemes.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.common import act_impl_of as j_act_impl_of  # noqa: E402
from repro.configs.common import fused_of as j_fused_of  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import (EngineConfig, EngineStats, ServeEngine,  # noqa: E402
                               StatsWindow)

MAX_PROMPT = 32
LENS = (9, 17, 30, 12)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deployment(dep="plain", scheme=None, **over):
    jc = JR.get("qwen3-0.6b", smoke=True, compute_dtype="float32", **over)
    tc = TR.get("qwen3-0.6b", smoke=True, compute_dtype="float32", **over)
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


def prompts_of(lens=LENS, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (n,)).astype(np.int32) for n in lens]


def _kw(gen, kw):
    out = dict(slots=2, chunk=4, max_prompt_len=MAX_PROMPT,
               max_len=MAX_PROMPT + gen)
    out.update(kw)
    return out


def serve_port(tc, tp, prompts, gen, engine_cls=ServeEngine, **kw):
    eng = engine_cls(tc, tp, EngineConfig(**_kw(gen, kw)), device="cpu")
    for p in prompts:
        eng.submit(p, max_new=gen)
    return [c.tokens for c in eng.run()], eng


def serve_ref(jc, jp, prompts, gen, **kw):
    eng = JServeEngine(jc, jp, JEngineConfig(**_kw(gen, kw)))
    for p in prompts:
        eng.submit(p, max_new=gen)
    return [c.tokens for c in eng.run()], eng


@pytest.fixture(scope="module")
def plain():
    jc, tc, jp, tp = deployment()
    prompts = prompts_of()
    slot, _ = serve_port(tc, tp, prompts, 10, cache="slot")
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts, slot=slot)


@pytest.mark.parametrize("page_size", [5, 1, 64])
def test_paged_tokens_match_reference_and_slot(plain, page_size):
    ref, _ = serve_ref(plain["jc"], plain["jp"], plain["prompts"], 10,
                       page_size=page_size)
    got, eng = serve_port(plain["tc"], plain["tp"], plain["prompts"], 10,
                          page_size=page_size)
    assert eng.paged and eng.ecfg.cache == "paged"
    assert got == ref == plain["slot"]
    assert eng._pool.in_use == 0 and eng._pool.reserved == 0
    assert eng.stats.pages_in_use == 0 and eng.stats.pages_peak > 0
    assert eng._pool.available() == eng._n_pages - 1


def test_sliding_window_ring_wraps_across_pages():
    """sliding_window=32 in both packages, page size 5: the ring is padded
    to 35 and decode wraps it several times."""
    jc, tc, jp, tp = deployment(sliding_window=32)
    prompts = prompts_of((9, 30, 17), seed=4)
    gen = 48
    ref, _ = serve_ref(jc, jp, prompts, gen, page_size=5)
    slot, _ = serve_port(tc, tp, prompts, gen, cache="slot")
    got, eng = serve_port(tc, tp, prompts, gen, page_size=5)
    assert eng._w_pad == 35 and not eng.prefix_enabled
    assert max(map(len, prompts)) + gen > 2 * eng._w_pad
    assert got == ref == slot


def _shared_prefix_prompts(ps, n_shared_pages, tails, seed):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 512, (n_shared_pages * ps,)).astype(np.int32)
    return [np.concatenate([shared, rng.randint(0, 512, (n,)).astype(
        np.int32)]) for n in tails]


def test_prefix_hit_matches_cold_and_reference(plain):
    """Three requests sharing a 2-page prefix, admitted serially: the
    second and third prefill only their suffixes, with the reference's
    prefix_hit_tokens, and emit the cold path's tokens."""
    ps = 8
    prompts = _shared_prefix_prompts(ps, 2, (5, 9, 1), seed=7)
    kw = dict(page_size=ps, admission="serial")
    cold, _ = serve_port(plain["tc"], plain["tp"], prompts, 8,
                         prefix_cache=False, **kw)
    warm, eng = serve_port(plain["tc"], plain["tp"], prompts, 8, **kw)
    ref, reng = serve_ref(plain["jc"], plain["jp"], prompts, 8, **kw)
    assert eng.prefix_enabled
    assert eng.stats.prefix_hit_tokens == reng.stats.prefix_hit_tokens \
        == 2 * 2 * ps
    assert eng.stats.prefill_tokens == reng.stats.prefill_tokens
    assert 0.0 < eng.stats.prefix_hit_rate < 1.0
    assert eng.stats.admitted_tokens_per_s > eng.stats.admission_tokens_per_s
    assert warm == cold == ref
    assert eng.stats.pages_in_use == 0


def test_identical_prompts_batched_share_one_chain(plain):
    ps = 8
    prompt = prompts_of((3 * ps + 3,), seed=8)[0]
    prompts = [prompt.copy() for _ in range(4)]
    cold, _ = serve_port(plain["tc"], plain["tp"], prompts, 6,
                         prefix_cache=False, page_size=ps)
    warm, eng = serve_port(plain["tc"], plain["tp"], prompts, 6,
                           page_size=ps)
    ref, reng = serve_ref(plain["jc"], plain["jp"], prompts, 6, page_size=ps)
    assert eng.stats.prefix_hit_tokens == reng.stats.prefix_hit_tokens > 0
    assert warm == cold == ref


def test_page_pressure_backpressures_and_completes(plain):
    """A pool of one worst-case request + 1 page: admission waits for
    decode to free pages, every request completes with the ample pool's
    tokens, and every page comes back."""
    prompts = prompts_of((20, 18, 25, 9), seed=6)
    gen = 8
    ample, _ = serve_port(plain["tc"], plain["tp"], prompts, gen, slots=4)
    n_slot = TM.pages_per_slot(plain["tc"], MAX_PROMPT + gen, 16)
    tight, eng = serve_port(plain["tc"], plain["tp"], prompts, gen, slots=4,
                            page_size=16, n_pages=n_slot + 2,
                            prefix_cache=False)
    assert tight == ample
    assert eng.stats.pages_peak <= n_slot + 1
    assert eng.stats.pages_in_use == 0
    assert eng.stats.prefill_batches > 1            # admission waited
    with pytest.raises(ValueError, match="n_pages"):
        ServeEngine(plain["tc"], plain["tp"], EngineConfig(
            slots=2, max_prompt_len=32, max_len=40, page_size=16,
            n_pages=2), device="cpu")


class PoisonedTrash(ServeEngine):
    """Fills the trash page (physical page 0) with 1e4 before every
    decode and prefill chunk. Finite on purpose: 0 x NaN is NaN in p @ V,
    so a NaN would poison even correctly masked keys."""

    def _push_tbl(self):
        super()._push_tbl()
        for pool in self.cache["layers"].values():
            pool[:, 0] = 1e4


@pytest.mark.parametrize("kw", [{}, {"chunk_prefill": 7, "page_size": 5}],
                         ids=["one_shot", "chunked"])
def test_poisoned_trash_page_leaves_tokens_unchanged(plain, kw):
    """Dead and unallocated rows all write page 0 at once; it is never
    read unmasked, so its contents cannot reach a token."""
    prompts = prompts_of((9, 17, 30, 12, 5), seed=9)
    clean, _ = serve_port(plain["tc"], plain["tp"], prompts, 8, slots=3,
                          **kw)
    dirty, eng = serve_port(plain["tc"], plain["tp"], prompts, 8, slots=3,
                            engine_cls=PoisonedTrash, **kw)
    assert float(eng.cache["layers"]["k"][:, 0].abs().max()) == 1e4
    assert dirty == clean


@pytest.mark.parametrize("dep,scheme", [("fused", "pwl"), ("kernel", "poly"),
                                        ("fused", "rational")])
def test_scheme_deployments_match_reference_paged(dep, scheme):
    jc, tc, jp, tp = deployment(dep, scheme)
    prompts = prompts_of((9, 17, 30), seed=4)
    ref, _ = serve_ref(jc, jp, prompts, 8, page_size=5)
    got, _ = serve_port(tc, tp, prompts, 8, page_size=5)
    assert got == ref


def test_stats_window_and_paged_gauges(plain):
    eng = ServeEngine(plain["tc"], plain["tp"], EngineConfig(**_kw(
        6, dict(page_size=8))), device="cpu")
    win = StatsWindow()
    for p in prompts_of((9, 17, 30), seed=2):
        eng.submit(p, max_new=6)
    eng.step()
    snap = eng.snapshot()
    assert snap.slots_in_use == 2 and snap.queue_depth == 1
    assert snap.pages_in_use > 0
    assert snap.pages_free == eng._pool.available() < eng._n_pages - 1
    first = win.tick(snap)
    assert first.decode_steps == snap.decode_steps > 0
    eng.run()
    second = win.tick(eng.snapshot())
    assert second.decode_steps == eng.stats.decode_steps - snap.decode_steps
    assert second.pages_free == eng._n_pages - 1       # a gauge: not diffed
    zero = EngineStats()
    assert zero.admitted_tokens_per_s == zero.prefix_hit_rate == 0.0


def test_slot_contract_ignores_paged_options(plain):
    got, eng = serve_port(plain["tc"], plain["tp"], plain["prompts"], 10,
                          cache="slot", chunk_prefill=7)
    assert not (eng.paged or eng.prefix_enabled or eng.chunked)
    assert "page_tbl" not in eng.cache
    assert got == plain["slot"] and eng.snapshot().pages_free == 0
    assert dataclasses.replace(EngineConfig(), slots=3).cache == "paged"
