"""Port vs reference: the multi-replica serving tier (``serve/router.py``,
``serve/replica.py``, ``launch/serve.py::serve_routed``).

Three layers, cheapest first. The policy layer (autoscaler hysteresis,
dispatch cost, ``StatsWindow``) and the routing layer (dispatch,
backpressure, drain / retire / revival) drive BOTH packages' ``Router``
over one scripted fake replica, built from each package's own types, and
demand the same decisions, ``RouterStats`` and completion records. The
engine layer serves the qwen3-0.6b smoke model through the port's
routed engines and demands the port's single-engine tokens and the
reference's routed tokens on the same (reference) weights; musicgen's
[S, 4] planes, temperature > 0 streams, real backpressure, one spawned
``ProcessReplica`` and the launcher's router flags follow. The reference
engines run once for the module (a fixture), prompts are short and one
process is spawned in the whole file.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as J  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

# ---------------------------------------------------------------- the fake

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_class(pkg):
    """The reference suite's FakeReplica (tests/test_serve_router.py) on
    ``pkg``'s types: completes each request after ``latency`` step()
    calls, a bounded number of concurrent slots, a FIFO queue behind."""

    class FakeReplica:
        def __init__(self, slots=2, latency=2, pages_free=0,
                     pages_per_slot=0):
            self.slots, self.latency = slots, latency
            self.pages_free, self.pages_per_slot = pages_free, pages_per_slot
            self.queue, self.running, self.meta = [], {}, {}
            self.done, self.submits = [], []
            self._stats = pkg.EngineStats()
            self.closed = False

        def submit(self, prompt_tokens, max_new, *, temperature=0.0,
                   eos_id=None, uid=None, arrival_s=None):
            self.submits.append(uid)
            self.meta[uid] = (len(prompt_tokens), arrival_s or 0.0)
            self.queue.append(uid)
            self._admit()
            return uid

        def _admit(self):
            while self.queue and len(self.running) < self.slots:
                self.running[self.queue.pop(0)] = self.latency

        def step(self):
            if not self.running and not self.queue:
                return False
            for uid in list(self.running):
                self.running[uid] -= 1
                if self.running[uid] <= 0:
                    del self.running[uid]
                    plen, arr = self.meta[uid]
                    self.done.append(pkg.Completion(
                        uid=uid, prompt_len=plen, tokens=[1, 2],
                        finish_reason="length", arrival_s=arr))
            self._admit()
            self._stats.decode_steps += 1
            self._stats.decode_tokens += len(self.running)
            return True

        def poll(self):
            out, self.done = self.done, []
            return out

        def load(self):
            return pkg.ReplicaLoad(
                queue_depth=len(self.queue),
                free_slots=self.slots - len(self.running), slots=self.slots,
                pages_free=self.pages_free,
                pages_per_slot=self.pages_per_slot, pending=self.pending)

        def stats(self):
            return dataclasses.replace(self._stats)

        @property
        def pending(self):
            return bool(self.queue) or bool(self.running)

        def close(self):
            self.closed = True

    return FakeReplica


def fake_router(pkg, n=2, fake_kw=None, **rcfg_kw):
    Fake, reps = fake_class(pkg), {}

    def factory(rid):
        reps[rid] = Fake(**(fake_kw or {}))
        return reps[rid]

    return pkg.Router(factory, pkg.RouterConfig(replicas=n, **rcfg_kw)), reps


def records(completions):
    """Completion records without their wall-clock stamps."""
    return [(c.uid, c.prompt_len, list(c.tokens), c.finish_reason)
            for c in completions]


def outcome(router, reps):
    """Everything a routing scenario decides, in plain values."""
    return {"stats": dataclasses.asdict(router.stats),
            "submits": {r: list(f.submits) for r, f in sorted(reps.items())},
            "queue": [q.uid for q in router.queue],
            "live": router.live_rids(), "replicas": sorted(router.replicas),
            "closed": {r: f.closed for r, f in sorted(reps.items())},
            "completions": records(router.completions)}


# ------------------------------------------------- policy, on both packages

def autoscaler_trace(pkg):
    """Hysteresis: the reference suite's signal sequences, one decision
    list per config."""
    S = pkg.AutoscaleSignal
    runs = [
        (dict(max_replicas=4, cooldown=0),
         [S(0.9, 3, 1), S(0.9, 0, 1), S(0.1, 3, 1)]),
        (dict(min_replicas=1, max_replicas=4, cooldown=0),
         [S(0.05, 0, 3), S(0.05, 1, 3), S(0.5, 0, 3)]),
        (dict(up_util=0.75, down_util=0.25, cooldown=0), [S(0.5, 2, 2)] * 5),
        (dict(max_replicas=8, cooldown=2), [S(1.0, 9, 1)] * 4),
        (dict(min_replicas=2, max_replicas=3, cooldown=0),
         [S(1.0, 9, 3), S(0.0, 0, 2)]),
        (dict(cooldown=1), [S(1.0, 5, 1), S(0.0, 0, 2), S(0.0, 0, 2),
                            S(0.8, 1, 1, draining=1)])]
    out = []
    for kw, sigs in runs:
        a = pkg.Autoscaler(pkg.AutoscaleConfig(**kw))
        out.append([a.observe(s) for s in sigs])
    return out


def dispatch_costs(pkg):
    L = pkg.ReplicaLoad
    loads = [L(0, 4, 4), L(3, 0, 4), L(0, 4, 4, 5, 4), L(0, 2, 4, 64, 4),
             L(0, 3, 4, 0, 0), L(2, 1, 2, 7, 3, True, 4)]
    return [(pkg.dispatch_cost(x), x.headroom) for x in loads]


def stats_windows(pkg):
    E = pkg.EngineStats
    a = E(decode_steps=10, decode_tokens=40, slots_in_use=3, queue_depth=2,
          pages_free=7, pages_in_use=5, prefill_s=0.5)
    b = E(decode_steps=16, decode_tokens=64, slots_in_use=1, queue_depth=0,
          pages_free=9, pages_in_use=2, prefill_s=0.75)
    w = pkg.StatsWindow()
    ticks = [w.tick(E(decode_steps=5, decode_tokens=10)),
             w.tick(E(decode_steps=8, decode_tokens=22)), w.tick(a),
             w.tick(b)]
    return ([dataclasses.asdict(b.delta(a))]
            + [dataclasses.asdict(t) for t in ticks]
            + [t.decode_utilization(slots=4) for t in ticks]
            + [E(decode_steps=10, decode_tokens=30).decode_utilization(4, 2)])


@pytest.mark.parametrize("scenario", [autoscaler_trace, dispatch_costs,
                                      stats_windows],
                         ids=lambda f: f.__name__)
def test_policy_units_match_reference(scenario):
    assert scenario(T) == scenario(J)


# ------------------------------------------------ routing, on both packages

def spread(pkg):
    router, reps = fake_router(pkg, n=3, fake_kw={"slots": 2})
    for _ in range(6):
        router.submit([1, 2, 3], max_new=4)
    return outcome(router, reps)


def ties_to_lowest(pkg):
    router, reps = fake_router(pkg, n=3)
    router.submit([1], max_new=2)
    return outcome(router, reps)


def queue_cap(pkg):
    router, reps = fake_router(pkg, n=2, replica_queue=1,
                               fake_kw={"slots": 1, "latency": 99})
    for _ in range(6):
        router.submit([1], max_new=2)
    return outcome(router, reps)


def headroom_first(pkg):
    router, reps = fake_router(pkg, n=2, fake_kw={"slots": 2, "latency": 99})
    reps[0].submit([1], 2, uid=100)
    reps[0].submit([1], 2, uid=101)
    router.submit([1], max_new=2)
    return outcome(router, reps)


def pages_bind(pkg):
    """Replica 0 has free slots but pages for one request only."""
    Fake, reps = fake_class(pkg), {}

    def factory(rid):
        reps[rid] = Fake(slots=4, latency=3, pages_free=5 if rid == 0 else 64,
                         pages_per_slot=4)
        return reps[rid]

    router = pkg.Router(factory, pkg.RouterConfig(replicas=2))
    for _ in range(5):
        router.submit([1, 2], max_new=2)
    router.run()
    return outcome(router, reps)


def run_uid_order(pkg):
    router, reps = fake_router(pkg, n=2, fake_kw={"latency": 3})
    uids = [router.submit([1, 2], max_new=4) for _ in range(7)]
    done = router.run()
    return outcome(router, reps), uids, records(done)


def close_all(pkg):
    router, reps = fake_router(pkg, n=2)
    router.close()
    return outcome(router, reps)


def reject(pkg):
    router, reps = fake_router(pkg, n=1, queue_limit=2,
                               fake_kw={"slots": 1, "latency": 99})
    got = [router.submit([1], max_new=2) for _ in range(6)]
    return outcome(router, reps), got


def shed(pkg):
    router, reps = fake_router(pkg, n=1, queue_limit=2, policy="shed",
                               fake_kw={"slots": 1, "latency": 99})
    got = [router.submit([1, 2, 3], max_new=2) for _ in range(6)]
    return outcome(router, reps), got


def exhaustion(pkg):
    out = []
    for policy in ("reject", "shed"):
        router, reps = fake_router(pkg, n=2, queue_limit=3, policy=policy,
                                   fake_kw={"slots": 1, "latency": 2})
        got = [router.submit([1], max_new=2) for _ in range(12)]
        done = records(router.run())
        out.append((outcome(router, reps), got, done))
    return out


def scale_up_and_down(pkg):
    Fake, reps = fake_class(pkg), {}

    def factory(rid):
        reps[rid] = Fake(slots=1, latency=4)
        return reps[rid]

    router = pkg.Router(factory, pkg.RouterConfig(
        replicas=1, queue_limit=64, replica_queue=1,
        autoscale=pkg.AutoscaleConfig(min_replicas=1, max_replicas=3,
                                      window=2, up_util=0.5, down_util=0.1,
                                      cooldown=0)))
    for _ in range(10):
        router.submit([1], max_new=2)
    done = records(router.run())
    for _ in range(8):
        router.step()
    return outcome(router, reps), done


def drain_before_retire(pkg):
    Fake, reps = fake_class(pkg), {}

    def factory(rid):
        reps[rid] = Fake(slots=1, latency=6)
        return reps[rid]

    router = pkg.Router(factory, pkg.RouterConfig(
        replicas=2, queue_limit=64, autoscale=pkg.AutoscaleConfig(
            min_replicas=1, max_replicas=2, window=1, up_util=2.0,
            down_util=1.0, cooldown=0)))
    for _ in range(2):
        router.submit([1], max_new=2)
    done = records(router.run())
    return outcome(router, reps), done


def revive_draining(pkg):
    Fake, reps = fake_class(pkg), {}

    def factory(rid):
        reps[rid] = Fake(slots=1, latency=99)
        return reps[rid]

    router = pkg.Router(factory, pkg.RouterConfig(
        replicas=2, autoscale=pkg.AutoscaleConfig(
            min_replicas=1, max_replicas=2, window=1, cooldown=0)))
    router._draining.add(1)
    router.replicas[1].submit([1], 2, uid=50)
    router.replicas[0].submit([1], 2, uid=51)
    router.submit([1], max_new=2)
    router.step()
    return outcome(router, reps), sorted(router._draining)


def initial_clamp(pkg):
    router, reps = fake_router(pkg, n=1, autoscale=pkg.AutoscaleConfig(
        min_replicas=2, max_replicas=4))
    return outcome(router, reps)


def fleet_totals(pkg):
    router, reps = fake_router(pkg, n=3, fake_kw={"latency": 3})
    for _ in range(5):
        router.submit([1, 2], max_new=2)
    router.run()
    return dataclasses.asdict(router.engine_totals()), outcome(router, reps)


ROUTING = [spread, ties_to_lowest, queue_cap, headroom_first, pages_bind,
           run_uid_order, close_all, reject, shed, exhaustion,
           scale_up_and_down, drain_before_retire, revive_draining,
           initial_clamp, fleet_totals]


@pytest.mark.parametrize("scenario", ROUTING, ids=lambda f: f.__name__)
def test_routing_matches_reference(scenario):
    """Both Routers over the same scripted fleet: the same dispatches,
    queue, fleet, RouterStats and completion records."""
    assert scenario(T) == scenario(J)


def test_routing_scenarios_do_what_they_claim():
    """The scenarios above exercise what their names say (the reference
    suite's own expectations, on the port)."""
    assert sorted(map(len, spread(T)["submits"].values())) == [2, 2, 2]
    assert ties_to_lowest(T)["submits"] == {0: [0], 1: [], 2: []}
    assert headroom_first(T)["submits"][1] == [0]
    out, got = reject(T)
    assert got == [0, 1, 2, 3, None, None] and out["stats"]["rejected"] == 2
    out, _ = shed(T)
    assert [c[0] for c in out["completions"]] == [2, 3]
    for out, _, done in exhaustion(T):
        st = out["stats"]
        assert st["completed"] + st["shed"] + st["rejected"] == 12
        assert st["completed"] + st["shed"] == len(done)
    out, done = scale_up_and_down(T)
    st = out["stats"]
    assert len(done) == 10 and st["scale_ups"] > 0 and st["scale_downs"] > 0
    assert st["retired"] > 0 and len(out["live"]) == 1
    out, done = drain_before_retire(T)
    assert len(done) == 2 and out["stats"]["retired"] >= 1
    out, draining = revive_draining(T)
    assert out["stats"]["scale_ups"] == 1 and draining == []
    assert out["replicas"] == [0, 1]
    assert initial_clamp(T)["live"] == [0, 1]


@pytest.mark.parametrize("cls,kw", [
    ("RouterConfig", dict(replicas=0)), ("RouterConfig", dict(queue_limit=0)),
    ("RouterConfig", dict(policy="drop")),
    ("RouterConfig", dict(replica_queue=0)),
    ("AutoscaleConfig", dict(min_replicas=3, max_replicas=2)),
    ("AutoscaleConfig", dict(up_util=0.2, down_util=0.5)),
    ("AutoscaleConfig", dict(window=0)), ("AutoscaleConfig", dict(cooldown=-1)),
    ("AutoscaleConfig", dict(min_replicas=0))],
    ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v.items())))
def test_config_validation_matches_reference(cls, kw):
    with pytest.raises(ValueError) as ref:
        getattr(J, cls)(**kw)
    with pytest.raises(ValueError) as port:
        getattr(T, cls)(**kw)
    assert str(port.value) == str(ref.value)


def test_exports_every_reference_serve_name():
    assert set(J.__all__) <= set(T.__all__)
    assert all(hasattr(T, n) for n in J.__all__)


# --------------------------------------------------- engines (qwen3 smoke)

LENS = (9, 14, 5, 12, 7)
GEN = 5
ECFG = dict(slots=2, max_prompt_len=16, max_len=16 + GEN, chunk=4)


@pytest.fixture(scope="module")
def smoke():
    """The reference's qwen3 smoke params (f32) on both packages, the
    prompts, and the reference's routed tokens at 3 replicas (the one
    reference run of the module)."""
    jc = JR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    tc = TR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    jp, _ = JM.materialize_params(jc, seed=0)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n in LENS]
    ref = J.Router(lambda rid: J.InProcessReplica(
        J.ServeEngine(jc, jp, J.EngineConfig(**ECFG))),
        J.RouterConfig(replicas=3))
    for p in prompts:
        ref.submit(p, max_new=GEN)
    ref_toks = {c.uid: c.tokens for c in ref.run()}
    single = T.ServeEngine(tc, tp, T.EngineConfig(**ECFG), device="cpu")
    for p in prompts:
        single.submit(p, max_new=GEN)
    base = {c.uid: c.tokens for c in single.run()}
    return dict(tc=tc, tp=tp, prompts=prompts, ref=ref_toks, base=base)


def port_router(cfg, params, n, **rcfg):
    return T.Router(lambda rid: T.InProcessReplica(
        T.ServeEngine(cfg, params, T.EngineConfig(**ECFG), device="cpu")),
        T.RouterConfig(replicas=n, **rcfg))


@pytest.mark.parametrize("n_replicas", [1, 3])
def test_routed_greedy_matches_single_engine_and_reference(smoke, n_replicas):
    """Placement is invisible in the output: the port's routed tokens per
    uid equal its single engine's and the reference's routed tokens."""
    router = port_router(smoke["tc"], smoke["tp"], n_replicas)
    for p in smoke["prompts"]:
        router.submit(torch.from_numpy(p), max_new=GEN)   # a CPU tensor
    done = router.run()
    got = {c.uid: c.tokens for c in done}
    assert got == smoke["base"] == smoke["ref"]
    assert all(c.finish_reason == "length" for c in done)
    for c in done:
        assert c.queue_s == pytest.approx(c.router_queue_s + c.engine_queue_s)
        assert c.latency_s >= c.queue_s >= 0.0
    total = router.engine_totals()
    assert total.prefill_requests == len(LENS)
    assert total.decode_tokens == sum(r.stats().decode_tokens
                                      for r in router.replicas.values())


def test_routed_sampling_placement_invariant(smoke):
    """temp > 0 streams are keyed by the router-global uid and the token
    index, so which replica serves a request cannot change its tokens."""
    streams = {}
    for n in (1, 2):
        router = port_router(smoke["tc"], smoke["tp"], n)
        for p in smoke["prompts"]:
            router.submit(p, max_new=GEN, temperature=0.7)
        streams[n] = {c.uid: c.tokens for c in router.run()}
    assert streams[1] == streams[2]
    assert streams[1] != smoke["base"]


def test_backpressure_on_real_engines_accounts_everything(smoke):
    """A one-slot paged fleet under a tight shed queue completes or
    honestly sheds every request, gives every page back, and serves the
    surviving uids the single engine's tokens."""
    router = T.Router(lambda rid: T.InProcessReplica(T.ServeEngine(
        smoke["tc"], smoke["tp"], T.EngineConfig(**dict(ECFG, slots=1,
                                                        page_size=4)),
        device="cpu")),
        T.RouterConfig(replicas=1, queue_limit=2, policy="shed",
                       replica_queue=1))
    for p in smoke["prompts"]:
        router.submit(p, max_new=GEN)
    done = router.run()
    st = router.stats
    assert st.completed + st.shed == st.submitted == len(LENS) == len(done)
    assert st.shed > 0
    for c in done:
        if c.finish_reason != "shed":
            assert c.tokens == smoke["base"][c.uid]
    for rep in router.replicas.values():
        assert rep.stats().pages_in_use == 0


def test_serve_routed_shares_one_copy_of_the_weights(smoke):
    """serve_routed casts once: every replica's engine holds the same
    weight tensors; bf16 compute (a cast) included; shed rows stay 0."""
    cfg = dataclasses.replace(smoke["tc"], compute_dtype="bfloat16")
    prompts = np.stack([p[:5] for p in smoke["prompts"]])
    toks, stats, router = tserve.serve_routed(
        cfg, smoke["tp"], prompts, GEN, replicas=2, device="cpu",
        queue_limit=1, policy="shed", slots=1)
    engines = [r.engine for r in router.replicas.values()]
    leaves = [tree_leaves(e.params) for e in engines]
    assert len(engines) == 2
    assert [t.data_ptr() for t in leaves[0]] == [t.data_ptr()
                                                 for t in leaves[1]]
    assert any(t.dtype == torch.bfloat16 for t in leaves[0])
    shed = [c.uid for c in router.completions if c.finish_reason == "shed"]
    assert shed and all(not toks[u].any() for u in shed)
    assert stats.decode_tokens == router.engine_totals().decode_tokens


def test_process_replica_matches_in_process(smoke):
    """One spawned worker (device="cpu") serves the tokens of an
    InProcessReplica built from the same materialized params, and exits
    0 on close()."""
    spec = T.ReplicaSpec(arch="qwen3-0.6b", smoke=True, seed=0, bf16=True,
                         engine=ECFG, device="cpu")
    cfg = TR.get("qwen3-0.6b", smoke=True)
    params = TM.materialize_params(cfg, seed=0, device="cpu")
    params = tserve._tree_cast(params, torch.bfloat16)
    local = T.Router(lambda rid: T.InProcessReplica(
        T.ServeEngine(cfg, params, T.EngineConfig(**ECFG), device="cpu")))
    remote = T.ProcessReplica(spec)
    try:
        router = T.Router(lambda rid: remote)
        for r in (local, router):
            for p in smoke["prompts"][:3]:
                r.submit(p, max_new=GEN)
        want = {c.uid: c.tokens for c in local.run()}
        got = router.run()
        assert {c.uid: c.tokens for c in got} == want
        assert all(isinstance(t, int) for c in got for t in c.tokens)
        assert remote.stats().prefill_requests == 3
        assert remote.load().free_slots == ECFG["slots"]
    finally:
        remote.close()
    assert remote.exitcode == 0
    # a TP replica (tests/test_torch_serve_tp.py serves through one)
    # takes its backend by name: gloo by default on the CPU, and nccl,
    # which needs a card per rank, is refused before anything spawns
    tp_spec = dataclasses.replace(spec, model_parallel=2)
    assert tp_spec.backend == "gloo"
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        T.ProcessReplica(dataclasses.replace(tp_spec, dist_backend="nccl"))
    with pytest.raises(ValueError, match="model_parallel must be >= 1"):
        T.ProcessReplica(dataclasses.replace(spec, model_parallel=0))


def test_routed_multicodebook_matches_single_engine():
    """musicgen smoke: [S, 4] prompts route as 4-tuples through 2
    replicas and give one engine's plane tokens."""
    cfg = TR.get("musicgen-large", smoke=True)
    params = TM.materialize_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (n, cfg.n_codebooks))
               .astype(np.int32) for n in (9, 6, 11)]
    single = T.ServeEngine(cfg, params, T.EngineConfig(**ECFG), device="cpu")
    for p in prompts:
        single.submit(p, max_new=GEN)
    base = {c.uid: c.tokens for c in single.run()}
    router = T.Router(lambda rid: T.InProcessReplica(
        T.ServeEngine(cfg, params, T.EngineConfig(**ECFG), device="cpu")),
        T.RouterConfig(replicas=2))
    for p in prompts:
        router.submit(p, max_new=GEN)
    got = {c.uid: c.tokens for c in router.run()}
    assert got == base
    assert all(len(t) == cfg.n_codebooks for ts in got.values() for t in ts)
    toks, _, _ = tserve.serve_routed(cfg, params, np.stack(
        [p[:6] for p in prompts]), GEN, replicas=2, device="cpu")
    assert tuple(toks.shape) == (3, GEN, cfg.n_codebooks)


def test_launcher_router_flags(tmp_path, capsys):
    out = tmp_path / "stats.json"
    tserve.main(["--smoke", "--device", "cpu", "--batch", "6",
                 "--prompt-len", "8", "--gen", "4", "--replicas", "2",
                 "--router-policy", "shed", "--router-queue", "2",
                 "--autoscale", "1:3", "--json", str(out)])
    assert "[serve] router:" in capsys.readouterr().out
    import json
    doc = json.loads(out.read_text())
    rs = doc["router"]
    assert rs["submitted"] == 6
    assert rs["completed"] + rs["shed"] + rs["rejected"] == 6
    assert tserve._parse_autoscale("2:5") == T.AutoscaleConfig(2, 5)
    assert tserve._parse_autoscale(None) is None
    with pytest.raises(SystemExit):
        tserve._parse_autoscale("3")


def test_serve_routed_rows_follow_requests_under_reject(smoke):
    """A rejected request takes no uid, so later uids are not row indices
    (the reference's serve_routed writes row c.uid and shifts every row
    after a rejection): the port keeps each request's tokens in its own
    row, the rejected rows all zero. Ragged prompts, as a list."""
    tc, tp, prompts = smoke["tc"], smoke["tp"], smoke["prompts"]
    toks, _, router = tserve.serve_routed(
        tc, tp, prompts, GEN, replicas=1, slots=1, queue_limit=1,
        policy="reject", device="cpu")
    assert router.stats.rejected > 0
    eng = T.ServeEngine(tc, tp, T.EngineConfig(
        slots=1, max_prompt_len=max(LENS), max_len=max(LENS) + GEN,
        chunk=GEN - 1), device="cpu")
    for p in prompts:
        eng.submit(p, max_new=GEN)
    want = {c.uid: c.tokens for c in eng.run()}
    zero = [b for b in range(len(LENS)) if not toks[b].any()]
    assert len(zero) == router.stats.rejected
    for b in range(len(LENS)):
        if b not in zero:
            assert toks[b].tolist() == want[b], b
