"""Port vs reference: chunked prefill interleaved with decode.

``EngineConfig(chunk_prefill=N)`` streams each prompt in chunks of at
most N tokens between decode chunks under a token budget. It is a pure
scheduling change, so greedy tokens must equal one-shot admission, the
reference's chunked engine and the port's slot path, request by request,
at f32 compute on the reference's weights: including chunk cursors that
cross page boundaries, a prefix hit that starts the cursor mid-prompt, a
sliding-window ring that wraps, and a token budget of 1. The decode
write mask keeps a mid-prefill slot bit for bit as it was.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.engine import make_decode_chunk  # noqa: E402

MAX_PROMPT = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deployment(**over):
    jc = JR.get("qwen3-0.6b", smoke=True, compute_dtype="float32", **over)
    tc = TR.get("qwen3-0.6b", smoke=True, compute_dtype="float32", **over)
    jp, _ = JM.materialize_params(jc, seed=0)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def prompts_of(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (n,)).astype(np.int32) for n in lens]


def _kw(gen, kw):
    out = dict(slots=2, chunk=4, page_size=5, max_prompt_len=MAX_PROMPT,
               max_len=MAX_PROMPT + gen)
    out.update(kw)
    return out


def serve_port(tc, tp, prompts, gen, temperature=0.0, **kw):
    eng = ServeEngine(tc, tp, EngineConfig(**_kw(gen, kw)), device="cpu")
    for p in prompts:
        eng.submit(p, max_new=gen, temperature=temperature)
    return [c.tokens for c in eng.run()], eng


def serve_ref(jc, jp, prompts, gen, **kw):
    eng = JServeEngine(jc, jp, JEngineConfig(**_kw(gen, kw)))
    for p in prompts:
        eng.submit(p, max_new=gen)
    return [c.tokens for c in eng.run()], eng


@pytest.fixture(scope="module")
def dense():
    return deployment()


def test_chunked_matches_one_shot_reference_and_slot(dense):
    jc, tc, jp, tp = dense
    prompts = prompts_of((9, 23, 5, 17), seed=1)
    ref, reng = serve_ref(jc, jp, prompts, 12, chunk_prefill=7)
    one_shot, _ = serve_port(tc, tp, prompts, 12)
    slot, _ = serve_port(tc, tp, prompts, 12, cache="slot")
    got, eng = serve_port(tc, tp, prompts, 12, chunk_prefill=7)
    assert eng.chunked and eng.stats.prefill_chunks > 0
    assert eng.stats.prefill_chunks == reng.stats.prefill_chunks
    assert eng.stats.prefill_tokens == sum(map(len, prompts))
    assert got == ref == one_shot == slot
    assert eng.stats.pages_in_use == 0 and eng._pool.reserved == 0


def test_chunked_sliding_window_ring_wraps():
    jc, tc, jp, tp = deployment(sliding_window=32)
    prompts = prompts_of((9, 23, 30), seed=2)
    gen = 40
    ref, _ = serve_ref(jc, jp, prompts, gen, chunk_prefill=7)
    got, eng = serve_port(tc, tp, prompts, gen, chunk_prefill=7)
    one_shot, _ = serve_port(tc, tp, prompts, gen)
    assert max(map(len, prompts)) + gen > eng._w_pad
    assert got == ref == one_shot


def test_cursor_crosses_page_boundaries(dense):
    """chunk 7 over page size 5: every chunk write straddles a page
    boundary and the final chunk is a 2-token remainder."""
    jc, tc, jp, tp = dense
    prompts = prompts_of((23,), seed=2)
    base, _ = serve_port(tc, tp, prompts, 8, slots=1)
    got, eng = serve_port(tc, tp, prompts, 8, slots=1, chunk_prefill=7)
    assert eng.stats.prefill_chunks == 4              # 7 + 7 + 7 + 2
    assert got == base


def test_prefix_hit_starts_cursor_mid_prompt(dense):
    """A prefix hit admits the cursor past the shared pages; the remaining
    chunks attend over cached pages they never wrote."""
    jc, tc, jp, tp = dense
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 512, (12,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 512, (n,)).astype(
        np.int32)]) for n in (6, 9, 3)]
    base, _ = serve_port(tc, tp, prompts, 10)
    ref, reng = serve_ref(jc, jp, prompts, 10, chunk_prefill=7)
    got, eng = serve_port(tc, tp, prompts, 10, chunk_prefill=7)
    assert eng.stats.prefix_hit_tokens == reng.stats.prefix_hit_tokens > 0
    assert got == ref == base


@pytest.mark.parametrize("kw", [dict(chunk_prefill=4, token_budget=1),
                                dict(chunk_prefill=16)],
                         ids=["budget_1", "single_chunk"])
def test_budget_extremes_still_drain(dense, kw):
    """A budget of one token an iteration still serves the whole workload
    (the planner's liveness floors), and prompts at or under the chunk
    take exactly one chunk each."""
    jc, tc, jp, tp = dense
    prompts = prompts_of((9, 14, 6), seed=5)
    base, _ = serve_port(tc, tp, prompts, 8)
    got, eng = serve_port(tc, tp, prompts, 8, **kw)
    assert got == base
    if kw["chunk_prefill"] == 16:
        assert eng.stats.prefill_chunks == 3


def test_chunked_temperature_streams_schedule_invariant(dense):
    """Keys derive from (uid, token index), so chunked, one-shot and
    untrimmed schedules draw the same tokens at temperature > 0."""
    _, tc, _, tp = dense
    prompts = prompts_of((9, 23, 5, 17), seed=4)
    base, _ = serve_port(tc, tp, prompts, 12, temperature=0.8)
    assert serve_port(tc, tp, prompts, 12, temperature=0.8,
                      chunk_prefill=7)[0] == base
    assert serve_port(tc, tp, prompts, 12, temperature=0.8, chunk_prefill=7,
                      trim_drain=False)[0] == base
    assert base != serve_port(tc, tp, prompts, 12)[0]


def test_latency_and_interleaving(dense):
    """TTFT is populated, and a short request keeps decoding
    while a long prompt prefills: it finishes first."""
    _, tc, _, tp = dense
    rng = np.random.RandomState(8)
    eng = ServeEngine(tc, tp, EngineConfig(
        slots=2, chunk=2, max_prompt_len=32, max_len=64, page_size=5,
        chunk_prefill=2, token_budget=4), device="cpu")
    eng.submit(rng.randint(0, 512, (4,)), max_new=6)
    eng.submit(rng.randint(0, 512, (30,)), max_new=2)
    done = {c.uid: c for c in eng.run()}
    assert done[0].finished_at < done[1].finished_at
    assert [len(done[0].tokens), len(done[1].tokens)] == [6, 2]
    for c in done.values():
        assert 0.0 < c.ttft_s <= c.latency_s


def test_write_mask_keeps_mid_prefill_slot(dense):
    """Serve until slot 1 is mid-prefill, then run a paged decode chunk:
    the slot's pages, k_pos row and cur come out bit for bit, while the
    decoding slot advances."""
    _, tc, _, tp = dense
    eng = ServeEngine(tc, tp, EngineConfig(
        slots=2, chunk=2, max_prompt_len=32, max_len=48, page_size=5,
        chunk_prefill=4, token_budget=6), device="cpu")
    prompts = prompts_of((5, 30), seed=6)
    for p in prompts:
        eng.submit(p, max_new=8)
    while eng._slot_pages.get(0) is None or \
            not eng._slot_pages[0].prefill_done or not eng.sched.slots[1]:
        eng.step()
    sp = eng._slot_pages[1]
    assert not sp.prefill_done and 0 < sp.prefill_pos < 30
    pages = torch.as_tensor(sp.pages)
    before = {n: v[:, pages].clone() for n, v in eng.cache["layers"].items()}
    row, cur0 = eng.cache["k_pos"][1].clone(), int(eng.cache["cur"][1])
    cur_dec = int(eng.cache["cur"][0])
    chunk = make_decode_chunk(tc, 2, paged=True)
    cache, state, toks = chunk(eng.params, eng.cache, eng.state, 0, [0, 0],
                               [1, 1], [0.0, 0.0])
    for n, v in cache["layers"].items():
        assert torch.equal(v[:, pages], before[n])
    assert torch.equal(cache["k_pos"][1], row)
    assert int(cache["cur"][1]) == cur0 and int(cache["cur"][0]) == cur_dec + 2
    assert not bool(state["active"][1]) and toks[:, 1].tolist() == [0, 0]


def test_serve_batch_threads_paged_options(dense):
    jc, tc, jp, tp = dense
    prompts = np.asarray(prompts_of((12, 12), seed=10))
    base, _ = tserve.serve_batch(tc, tp, prompts, 6, cache="slot",
                                 device="cpu")
    for kw in (dict(), dict(chunk_prefill=5), dict(page_size=4,
                                                   prefix_cache=False),
               dict(chunk_prefill=5, token_budget=3)):
        toks, st = tserve.serve_batch(tc, tp, prompts, 6, device="cpu", **kw)
        np.testing.assert_array_equal(toks.numpy(), base.numpy())
        assert st.decode_tokens == 2 * 5
    with pytest.raises(ValueError, match="token_budget"):
        tserve.serve_batch(tc, tp, prompts, 6, token_budget=3, device="cpu")
