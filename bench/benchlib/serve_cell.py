"""A serving cell: the program's ``ServeEngine`` (``submit`` / ``step``)
under an open loop (arrivals on a Poisson schedule at the cell's fixed
rate, timed from each request's due time) or a closed loop (clients that
send their next request when the last one's final token reaches them).

Set-up makes the weights from the seed, builds the engine, serves one
short request (a checkout's first run builds the kernels there), and
runs the traffic itself for the cell's warm-up, so the window starts in
the steady state with every shape the traffic uses already run. The
window is a whole number of engine steps, from the end of the warm-up's
last step to the end of the first step past ``--seconds``. After it the
requests due in it are waited for, at most ``drain_s`` (an open loop's
arrivals go on, a closed loop's clients stop); a request due in the
window fails if it completes with another number of tokens than it
asked for (no request has an end-of-sequence token) or has made no
progress for ``stall_s``. Then the engine is freed, and the plain
reference reads a sample, drawn from the seed with the longest among
them, of the requests finished since the window opened, over their
prompts and served tokens.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchref import lm as ref

from . import roofline, traffic, weights


WARM_UID = 2**40     # the set-up request's uid, apart from the traffic's


def p95(values) -> float:
    """The nearest-rank 95th percentile (inf for a missing value)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)] if v else math.inf


class Loop:
    """The client side: submits requests when due, steps the engine, and
    keeps each request's due, admission, first-token and finish times."""

    def __init__(self, eng, cell, seed: int, horizon_s: float, uid0: int = 0):
        self.eng = eng
        self.uid0 = uid0
        t = cell.traffic
        self.open = t["loop"] == "open"
        vocab = cell.model["vocab_size"]
        if self.open:
            rate = cell.settings["rate_per_s"]
            n = int(math.ceil(rate * horizon_s * 1.25)) + 64
            self.reqs = traffic.requests(t, n, vocab, seed)
            self.sched = traffic.arrivals(rate, n, seed)
        else:
            self.clients = t["clients"]
            per = cell.settings.get("requests_per_client", 8)
            self.reqs = traffic.requests(t, self.clients * per, vocab, seed)
            if cell.settings.get("steady_start"):
                # the loop starts in its steady state: each client is partway
                # through its first answer, a share (i + 0.5) / clients of
                # it left, the shares in the seed's order
                share = traffic.rng(seed, "steady").permutation(
                    (np.arange(self.clients) + 0.5) / self.clients)
                for c in range(self.clients):
                    p, o = self.reqs[c]
                    self.reqs[c] = (p, max(1, int(round(o * share[c]))))
            ramp = cell.settings.get("ramp_s", 0.0)
            self.sched = [c * ramp / self.clients for c in range(self.clients)]
            self.per = per
            self.next_of = [0] * self.clients     # requests sent per client
            self.owner: dict = {}
        self.t_start = None
        self.sent = 0
        self.due: dict = {}
        self.first: dict = {}
        self.last: dict = {}                       # uid -> its latest token
        self.done: dict = {}                       # uid -> Completion
        self.seen = 0                              # completions harvested
        self.tokens = 0                            # served tokens on the host
        self.live = 0                              # of them, not yet done
        self.engine_s = 0.0
        self.submitting = True

    def req(self, uid: int):
        """(prompt, output tokens) of request ``uid``."""
        return self.reqs[uid - self.uid0]

    def _submit(self, uid: int, due: float):
        prompt, n_out = self.req(uid)
        self.due[uid] = due
        self.eng.submit(prompt, n_out, uid=uid, arrival_s=due)
        self.sent += 1

    def pump(self, now: float):
        if not self.submitting:
            return
        if self.open:
            while self.sent < len(self.reqs) and \
                    self.t_start + self.sched[self.sent] <= now:
                self._submit(self.uid0 + self.sent,
                             self.t_start + self.sched[self.sent])
            if self.sent == len(self.reqs):
                raise RuntimeError("the open loop ran out of requests")
            return
        for c in range(self.clients):
            k = self.next_of[c]
            if k == 0:
                due = self.t_start + self.sched[c]
                if due > now:
                    continue
            else:
                prev = self.done.get(self.owner.get((c, k - 1)))
                if prev is None:
                    continue
                due = prev.finished_at
            if k >= self.per:
                raise RuntimeError("a closed-loop client ran out of requests")
            uid = self.uid0 + c + k * self.clients
            self.owner[(c, k)] = uid
            self.next_of[c] = k + 1
            self._submit(uid, due)

    def step(self) -> float:
        """One engine step (or a short wait when there is nothing to do);
        returns the time it ended."""
        eng = self.eng
        self.pump(time.perf_counter())
        t0 = time.perf_counter()
        busy = eng.step()
        t1 = time.perf_counter()
        if busy:
            self.engine_s += t1 - t0
        else:
            self._idle(t1)
        for c in eng.completions[self.seen:]:
            self.done[c.uid] = c
            self.first.setdefault(c.uid, c.arrival_s + c.ttft_s)
            self.tokens += len(c.tokens)
        self.seen = len(eng.completions)
        live = 0
        for run in eng.sched.slots:
            if run is not None and run.token_times:
                self.first.setdefault(run.request.uid, run.token_times[0])
                self.last[run.request.uid] = run.token_times[-1]
                live += len(run.tokens)
        self.live = live
        return t1

    def _idle(self, now: float):
        if self.open and self.sent < len(self.reqs):
            wait = self.t_start + self.sched[self.sent] - now
            time.sleep(min(max(wait, 0.0), 0.002))
        else:
            time.sleep(0.001)

    def failed(self, uid: int, now: float, stall_s: float) -> bool:
        """Whether request ``uid`` failed: it completed with another number
        of tokens than it asked for, or it has not completed and its last
        token (or its due time, before a first one) lies more than
        ``stall_s`` back: it stopped making progress."""
        if uid in self.done:
            return len(self.done[uid].tokens) != self.req(uid)[1]
        return now - self.last.get(uid, self.due[uid]) > stall_s

    def host_tokens(self) -> int:
        return self.tokens + self.live


def run(cell, args, rec, device, say, program=None):
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    from .spec import program_config
    s = cell.settings
    cfg = program_config(cell.config)
    model = cell.model
    w = weights.make(cfg, model, args.seed, "serve", device)
    eng = ServeEngine(cfg, w, EngineConfig(**s["engine"]), device=device)
    if program is not None:
        program(eng)
    # one short request first: a checkout's first run builds the program's
    # kernels in its first step, and arrivals piled up behind the build
    # would be admitted as one prefill of more rows than the card holds
    eng.submit(np.arange(16) % model["vocab_size"], 2, uid=WARM_UID)
    while eng.step():
        pass
    warm, drain = s["warmup_s"], s["drain_s"]
    loop = Loop(eng, cell, args.seed, warm + args.seconds + drain)
    loop.seen = len(eng.completions)
    loop.t_start = time.perf_counter()
    while time.perf_counter() - loop.t_start < warm:
        loop.step()
    _sync(device)
    tw0 = time.perf_counter()
    rec.setup_s = tw0 - rec.t_process
    say(f"set-up {rec.setup_s:.3f} s (warm-up {warm} s: {loop.sent} requests "
        f"sent, {len(loop.done)} done)")

    # -- the window ----------------------------------------------------------
    st0, tok0, eng_s0 = eng.snapshot(), loop.host_tokens(), loop.engine_s
    while True:
        t1 = loop.step()
        if t1 - tw0 >= args.seconds:
            break
    tw1 = t1
    st1, tok1 = eng.snapshot(), loop.host_tokens()
    engine_s = loop.engine_s - eng_s0
    stats = st1.delta(st0)
    in_window = [u for u, d in loop.due.items() if tw0 <= d < tw1]

    if args.trace:
        from . import trace
        k = s["trace"]["steps"]

        def sliced(launches):
            wrap = {"_prefill": "bench.prefill", "_insert": "bench.insert"}
            saved = {a: getattr(eng, a) for a in wrap}
            orig_decode_at = eng._decode_at

            def ranged(fn, name):
                def inner(*a, **kw):
                    with launches.in_range(name):
                        return fn(*a, **kw)
                return inner

            for a, name in wrap.items():
                setattr(eng, a, ranged(saved[a], name))
            eng._decode_at = lambda n: ranged(orig_decode_at(n), "bench.decode")
            d0 = eng.stats.decode_steps
            try:
                for _ in range(k):
                    loop.step()
            finally:
                for a in wrap:
                    setattr(eng, a, saved[a])
                eng._decode_at = orig_decode_at
            steps["bench.decode"] = eng.stats.decode_steps - d0

        steps: dict = {}
        rec.slice = trace.take(sliced, steps, say)

    # -- wait for the window's requests --------------------------------------
    if loop.open is False:
        loop.submitting = False
    t_close = time.perf_counter()
    while any(u not in loop.done for u in in_window) and \
            time.perf_counter() - t_close < drain:
        loop.step()
    t_end = time.perf_counter()
    failed = [u for u in in_window if loop.failed(u, t_end, s["stall_s"])]
    rec.attempted, rec.failed = len(in_window), len(failed)

    wall = tw1 - tw0
    ttft = [(loop.first[u] - loop.due[u]) if u in loop.first else math.inf
            for u in in_window]
    finished = [c for c in loop.done.values() if tw0 < c.finished_at <= tw1]
    tpot = [(c.finished_at - loop.first[c.uid]) / (len(c.tokens) - 1)
            for c in finished if len(c.tokens) > 1]
    queue = [((loop.done[u].admitted_at if u in loop.done else math.inf)
              - loop.due[u]) for u in in_window]
    emitted = tok1 - tok0
    rec.window = {
        "wall_s": wall, "engine_s": engine_s, "requests": len(in_window),
        "finished": len(finished), "tokens": emitted,
        "prefill_tokens": stats.prefill_tokens,
        "decode_s": stats.decode_s, "decode_steps": stats.decode_steps,
        "decode_utilization": stats.decode_utilization(s["engine"]["slots"]),
        "queue_wait_p95_s": p95(queue),
        "model_flops": roofline.model_flops(
            model, stats.prefill_tokens + emitted, "forward"),
    }
    rec.metrics.update(serve_tok_s=emitted / wall,
                       ttft_p95_ms=1e3 * p95(ttft),
                       tpot_p95_ms=1e3 * p95(tpot))
    say(f"window {wall:.3f} s: {len(in_window)} requests due, "
        f"{len(finished)} finished, {emitted} tokens; engine busy "
        f"{engine_s:.3f} s; failed {len(failed)}")

    # -- the check -------------------------------------------------------------
    gen = traffic.rng(args.seed, "sample")
    done = [u for u, c in loop.done.items()
            if c.finished_at >= tw0 and u not in failed]
    seqs = []
    if done:
        size = lambda u: len(loop.req(u)[0]) + len(loop.done[u].tokens)
        longest = max(done, key=size)
        order = [longest] + [u for u in gen.permutation(done) if u != longest]
        served = 0
        for u in order[: s["check"]["max_requests"]]:
            toks = [int(x) for x in loop.done[u].tokens]
            prompt = [int(x) for x in loop.req(u)[0]]
            seqs.append((prompt + toks[:-1], len(prompt), toks))
            served += len(toks)
            if served >= s["check"]["tokens"]:
                break
    if device.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)
    del eng, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec.sample = [(p, len(t)) for _, p, t in seqs]
    rec.readings = gaps(w, seqs, model, getattr(args, "precisions", ("f32",)))
    rec.reference = None


def gaps(w, seqs, model, precisions) -> dict:
    """Over the sample's served positions: the widest and the mean gap by
    which a served token's logit lies below the f32 reference's best
    (``served_gap``, ``served_gap_mean``) and, for a lower precision, the
    same two of the token it puts first (``fp8_top_gap``, ...)."""
    ref.exact_f32()
    if not seqs:
        return {"served_gap": math.inf, "served_gap_mean": math.inf}
    out = ref.served_gaps(w, seqs, ref.Arch.of(model),
                          precisions=tuple(dict.fromkeys(("f32",) + precisions)))

    def both(name, key):
        g = torch.cat([x[key] for x in out[name]])
        return float(g.max()), float(g.mean())

    res = dict(zip(("served_gap", "served_gap_mean"), both("f32", "served_gap")))
    for name in precisions:
        if name != "f32":
            res.update(zip((f"{name}_top_gap", f"{name}_top_gap_mean"),
                           both(name, "top_gap")))
    return res


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
