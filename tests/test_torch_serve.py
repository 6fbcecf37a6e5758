"""Port vs reference: continuous-batching serving at f32 compute.

Both packages serve the same ragged requests on the same (reference)
weights; greedy tokens must be identical, request by request, under the
plain config, the fused deployment and the kernelized engine. Prompts
span two prefill buckets, there are fewer slots than requests, one
request stops on an EOS token, and admission runs batched and serial.
Temperature > 0 streams cannot match the reference (its keys come from
``jax.random``); the port is held to its own schedule invariance.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.common import act_impl_of as j_act_impl_of  # noqa: E402
from repro.configs.common import fused_of as j_fused_of  # noqa: E402
from repro.launch.serve import serve_batch as j_serve_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.kernels import epilogue as tepi  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import (EngineConfig, EngineStats, ServeEngine,  # noqa: E402
                               bucket_len)
from repro_torch.serve.engine import token_seed  # noqa: E402
from repro_torch.serve.scheduler import (FifoScheduler, Request,  # noqa: E402
                                         SlotRun)

LENS = (9, 17, 30, 12, 5)        # buckets 16 and 32
GEN = 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def prompts_of(lens=LENS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (n,)).astype(np.int32) for n in lens]


def serve_port(tc, tp, prompts, *, eos=None, temperature=0.0, **ecfg):
    kw = dict(slots=2, max_prompt_len=32, max_len=32 + GEN, chunk=4)
    kw.update(ecfg)
    eng = ServeEngine(tc, tp, EngineConfig(**kw), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=GEN, temperature=temperature,
                   eos_id=eos if i == 0 else None)
    return eng.run(), eng


def serve_ref(jc, jp, prompts, *, eos=None):
    eng = JServeEngine(jc, jp, JEngineConfig(
        slots=2, max_prompt_len=32, max_len=32 + GEN, chunk=4, cache="slot"))
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=GEN, eos_id=eos if i == 0 else None)
    return eng.run()


@pytest.fixture(scope="module", params=["plain", "fused", "kernel"])
def served(request):
    jc, tc, jp, tp = deployment(request.param)
    prompts = prompts_of()
    ref = serve_ref(jc, jp, prompts)
    # an EOS that first appears mid-stream in request 0
    toks0 = ref[0].tokens
    k = next(k for k in range(2, GEN) if toks0[k] not in toks0[:k])
    ref_eos = serve_ref(jc, jp, prompts, eos=toks0[k])
    return dict(tc=tc, tp=tp, prompts=prompts, ref=ref, eos=toks0[k],
                stop=k, ref_eos=ref_eos)


@pytest.mark.parametrize("variant", [
    {}, {"admission": "serial"}, {"slots": 3}, {"trim_drain": False},
    {"chunk": 7}])
def test_greedy_tokens_identical_to_reference(served, variant):
    done, eng = serve_port(served["tc"], served["tp"], served["prompts"],
                           **variant)
    assert [c.uid for c in done] == list(range(len(LENS)))
    assert [c.tokens for c in done] == [c.tokens for c in served["ref"]]
    assert all(c.finish_reason == "length" for c in done)
    if variant == {"admission": "serial"}:
        assert eng.stats.prefill_batches == len(LENS)


def test_eos_row_identical_to_reference(served):
    done, _ = serve_port(served["tc"], served["tp"], served["prompts"],
                         eos=served["eos"])
    ref = served["ref_eos"]
    assert [c.tokens for c in done] == [c.tokens for c in ref]
    assert done[0].finish_reason == ref[0].finish_reason == "eos"
    assert done[0].tokens == served["ref"][0].tokens[:served["stop"] + 1]
    assert [c.finish_reason for c in done[1:]] == ["length"] * (len(LENS) - 1)


def test_serve_batch_identical_to_reference():
    jc, tc, jp, tp = deployment("fused")
    prompts = np.random.RandomState(9).randint(0, 512, (3, 10)).astype(
        np.int32)
    jt, _ = j_serve_batch(jc, jp, jnp.asarray(prompts), 8, cache="slot")
    tt, st = tserve.serve_batch(tc, tp, prompts, 8, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert st.decode_steps > 0 and st.decode_tokens == 3 * 7
    eos = int(np.asarray(jt)[0, 3])
    te, _ = tserve.serve_batch(tc, tp, prompts, 8, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(
        te.numpy(), tserve._mask_after_eos(np.asarray(jt), eos))


@pytest.mark.parametrize("dep", ["plain", "fused", "kernel"])
@pytest.mark.parametrize("scheme", ["pwl", "poly", "rational"])
def test_scheme_greedy_tokens_identical_to_reference(scheme, dep):
    """Each scheme through the whole serving stack (ragged bucketed
    prefill, slot insert, chunked decode), on the reference's params: the
    same greedy tokens, request by request."""
    jc, tc, jp, tp = deployment(dep, scheme)
    prompts = prompts_of((9, 17, 30), seed=4)
    ref = serve_ref(jc, jp, prompts)
    done, _ = serve_port(tc, tp, prompts)
    assert [c.tokens for c in done] == [c.tokens for c in ref]
    assert all(len(c.tokens) == GEN for c in done)


@pytest.fixture(scope="module")
def smoke():
    tc = TR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    return tc, TM.materialize_params(tc, seed=3, device="cpu")


def test_temperature_streams_schedule_invariant(smoke):
    tc, tp = smoke
    prompts = prompts_of(seed=6)
    base, _ = serve_port(tc, tp, prompts, temperature=0.8, slots=1)
    streams = [c.tokens for c in base]
    for kw in ({"slots": 3}, {"admission": "serial", "slots": 2},
               {"chunk": 3, "trim_drain": False}):
        done, _ = serve_port(tc, tp, prompts, temperature=0.8, **kw)
        assert [c.tokens for c in done] == streams, kw
    greedy, _ = serve_port(tc, tp, prompts)
    assert streams != [c.tokens for c in greedy]
    assert all(0 <= t < tc.padded_vocab for s in streams for t in s)
    assert token_seed(0, 1, 2) != token_seed(0, 2, 1)


def test_trimmed_and_untrimmed_drain_agree(smoke):
    tc, tp = smoke
    prompts = prompts_of((9, 14, 20), seed=3)
    runs = {}
    for trim in (True, False):
        done, eng = serve_port(tc, tp, prompts, trim_drain=trim, chunk=8,
                               max_len=32 + 6)
        runs[trim] = ([c.tokens for c in done], eng.stats.decode_steps,
                      set(eng._decode_fns))
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] < runs[False][1]
    assert runs[False][2] == {8}


def test_stats_rates_finite_and_consistent(smoke):
    tc, tp = smoke
    prompts = prompts_of(seed=4)
    done, eng = serve_port(tc, tp, prompts)
    st = eng.stats
    assert st.prefill_requests == len(prompts)
    assert st.prefill_tokens == sum(LENS)
    assert st.prefill_padded_tokens >= st.prefill_tokens
    assert st.decode_tokens == sum(len(c.tokens) - 1 for c in done)
    assert st.decode_tokens <= st.decode_steps * eng.ecfg.slots
    for s in (st.prefill_s, st.insert_s, st.decode_s):
        assert math.isfinite(s) and s > 0.0
    assert st.prefill_tokens_per_s == pytest.approx(
        st.prefill_tokens / st.prefill_s)
    assert st.decode_tokens_per_s == pytest.approx(
        st.decode_tokens / st.decode_s)
    assert st.admission_tokens_per_s < st.prefill_tokens_per_s
    assert 0.0 < st.decode_utilization(eng.ecfg.slots) <= 1.0
    snap = eng.snapshot()
    assert snap.slots_in_use == 0 and snap.queue_depth == 0
    assert snap.delta(snap).decode_tokens == 0
    zero = EngineStats()
    assert zero.prefill_tokens_per_s == zero.decode_tokens_per_s == 0.0
    assert zero.admission_tokens_per_s == 0.0
    sst = tserve.ServeStats(0.0, 0.0, 2, 8, 1, 0, 0)
    assert sst.prefill_tokens_per_s == sst.decode_tokens_per_s == 0.0


def test_cpu_serving_launches_no_kernel(smoke):
    tc, tp = smoke
    before = dict(tepi.LAUNCHES)
    serve_port(fused_of(tc), tp, prompts_of((9, 5)))
    assert tepi.LAUNCHES == before


def test_single_token_requests_complete_at_admission(smoke):
    tc, tp = smoke
    eng = ServeEngine(tc, tp, EngineConfig(slots=1, max_prompt_len=32,
                                           max_len=40, chunk=2), device="cpu")
    for n, new in ((8, 1), (11, 4), (9, 1)):
        eng.submit(np.arange(n) % 500, max_new=new)
    done = eng.run()
    assert [len(c.tokens) for c in done] == [1, 4, 1]
    assert all(c.finish_reason == "length" for c in done)


def test_engine_config_rejects_unported_and_invalid():
    """The reference's defaults (the paged cache first) and its
    validation errors."""
    assert EngineConfig().cache == "paged"
    assert dataclasses.asdict(EngineConfig()) == \
        dataclasses.asdict(JEngineConfig())
    assert {f.name for f in dataclasses.fields(EngineConfig)} == \
        {f.name for f in dataclasses.fields(JEngineConfig)}
    for kw, match in (({"cache": "bogus"}, "cache"),
                      ({"max_prompt_len": 64, "max_len": 64},
                       "max_prompt_len"),
                      ({"admission": "bogus"}, "admission"),
                      ({"slots": 0}, "slots"),
                      ({"page_size": 0}, "page_size"),
                      ({"n_pages": 1}, "n_pages"),
                      ({"chunk_prefill": -1}, "chunk_prefill"),
                      ({"token_budget": 8}, "token_budget"),
                      ({"chunk_prefill": 4, "token_budget": 0},
                       "token_budget")):
        with pytest.raises(ValueError, match=match):
            EngineConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JEngineConfig(**kw)


def test_launcher_main_on_cpu(tmp_path, capsys):
    out = tmp_path / "stats.json"
    stats = tserve.main(["--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "8", "--gen", "4", "--act-impl",
                         "cr_spline", "--act-impl-kernel", "--json",
                         str(out)])
    assert stats.decode_steps == 3 and out.exists()
    assert "device=cpu" in capsys.readouterr().out
    for scheme in ("pwl", "poly", "rational"):
        for extra in ([], ["--act-impl-kernel"]):
            st = tserve.main(["--smoke", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--gen", "3",
                              "--act-impl", scheme] + extra)
            assert st.decode_steps == 2
        assert f"act_impl={scheme}" in capsys.readouterr().out
    # every reference flag is ported: the router's
    # (tests/test_torch_router.py) and --model-parallel
    # (tests/test_torch_serve_tp.py). NCCL needs a CUDA device per rank,
    # so asking for it on the CPU is a clear error, not a silent gloo
    assert set(tserve._UNPORTED_FLAGS) == set()
    with pytest.raises(SystemExit, match="nccl backend needs CUDA"):
        tserve.main(["--smoke", "--device", "cpu", "--model-parallel", "2",
                     "--dist-backend", "nccl"])


@pytest.mark.parametrize("flags", [
    ["--cache", "slot"], ["--cache", "paged", "--page-size", "4"],
    ["--no-prefix-cache"], ["--chunk-prefill", "3"],
    ["--chunk-prefill", "3", "--token-budget", "2"]],
    ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_launcher_main_on_cpu_cache_flags(flags):
    """The cache and schedule flags reach the engine: every request is
    served in full under each."""
    st = tserve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"] + flags)
    assert st.decode_tokens == 2 * 3 and st.decode_steps >= 3


# --- scheduler (host Python, ported whole) ---------------------------------

class TestScheduler:
    def test_bucketing(self):
        assert bucket_len(9, min_bucket=16, max_len=64) == 16
        assert bucket_len(17, min_bucket=16, max_len=64) == 32
        assert bucket_len(33, min_bucket=16, max_len=64) == 64
        assert bucket_len(64, min_bucket=16, max_len=64) == 64
        assert bucket_len(21, min_bucket=16, max_len=64, exact=True) == 21
        assert bucket_len(33, min_bucket=16, max_len=48) == 48
        assert bucket_len(48, min_bucket=16, max_len=48) == 48
        for exact in (False, True):
            with pytest.raises(ValueError, match="max_len"):
                bucket_len(65, min_bucket=16, max_len=64, exact=exact)

    def test_next_batch_groups_by_head_bucket(self):
        def bucket_of(req):
            return bucket_len(len(req.tokens), min_bucket=16, max_len=64)

        s = FifoScheduler(4)
        for i, n in enumerate([9, 30, 12, 14, 40, 10]):
            s.submit(Request(uid=i, tokens=[0] * n, max_new=2))
        assert [r.uid for r in s.next_batch(3, bucket_of)] == [0, 2, 3]
        assert [r.uid for r in s.queue] == [1, 4, 5]
        assert [r.uid for r in s.next_batch(4, bucket_of)] == [1]
        assert [r.uid for r in s.next_batch(4, bucket_of)] == [4]
        assert [r.uid for r in s.next_batch(4, bucket_of)] == [5]
        assert s.next_batch(4, bucket_of) == []

    def test_next_batch_full_batch_leaves_tail_untouched(self):
        calls = []

        def bucket_of(req):
            calls.append(len(req.tokens))
            return bucket_len(len(req.tokens), min_bucket=16, max_len=64)

        s = FifoScheduler(4)
        for i, n in enumerate([9, 30, 12, 14, 40, 10, 11, 13]):
            s.submit(Request(uid=i, tokens=[0] * n, max_new=2))
        tail_ids = [id(r) for r in list(s.queue)[4:]]
        assert [r.uid for r in s.next_batch(3, bucket_of)] == [0, 2, 3]
        assert [r.uid for r in s.queue] == [1, 4, 5, 6, 7]
        assert [id(r) for r in list(s.queue)[1:]] == tail_ids
        assert len(calls) == 5

    def test_next_batch_respects_width(self):
        def bucket_of(req):
            return bucket_len(len(req.tokens), min_bucket=16, max_len=64)

        s = FifoScheduler(2)
        for i in range(5):
            s.submit(Request(uid=i, tokens=[0] * 8, max_new=2))
        assert [r.uid for r in s.next_batch(2, bucket_of)] == [0, 1]
        assert [r.uid for r in s.next_batch(2, bucket_of)] == [2, 3]
        assert [r.uid for r in s.next_batch(0, bucket_of)] == []
        assert [r.uid for r in s.next_batch(2, bucket_of)] == [4]

    def test_fifo_slot_lifecycle(self):
        s = FifoScheduler(2)
        for i in range(3):
            s.submit(Request(uid=i, tokens=[1], max_new=2))
        assert s.free_slots() == [0, 1]
        s.bind(0, SlotRun(request=s.next_request(), tokens=[], admitted_at=0))
        s.bind(1, SlotRun(request=s.next_request(), tokens=[], admitted_at=0))
        assert s.free_slots() == [] and s.pending
        assert s.evict(0).request.uid == 0
        assert s.free_slots() == [0]
        s.bind(0, SlotRun(request=s.next_request(), tokens=[], admitted_at=0))
        assert s.slots[0].request.uid == 2
        s.evict(0), s.evict(1)
        assert not s.pending

    def test_plan_step_matches_reference(self):
        from repro.serve.scheduler import TokenBudgetScheduler as J
        kw = dict(budget=40, chunk_tokens=16, decode_steps=8, n_decode=3,
                  prefill_left=[(0, 30), (2, 5)])
        assert dataclasses.astuple(FifoScheduler(4).plan_step(**kw)) == \
            dataclasses.astuple(J(4).plan_step(**kw))
