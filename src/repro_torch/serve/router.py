"""Multi-replica serving tier: load-aware router, admission
backpressure, and stats-driven autoscaling (counterpart of
``repro/serve/router.py``; host-side bookkeeping only, the engines do
the device work).

One `ServeEngine` is one host. The `Router` is the layer above: it
owns a BOUNDED front queue, spreads the stream over N replicas
(replica.py — in-process engines stepped round-robin, or subprocess
workers behind the same protocol), and keeps the fleet sized to the
load.

Dispatch is load-aware. Each candidate replica is scored

    cost(r) = queue_depth(r) - headroom(r)
    headroom = min(free_slots, pages_free // pages_per_slot)

i.e. requests already waiting ahead of you, minus requests the replica
could admit immediately (slot-bound AND page-bound — a replica whose
PagePool is drained by long contexts stops looking attractive even
with free slots). Lowest cost wins; ties go to the lowest replica id,
so routing is deterministic. A replica whose engine queue has reached
`replica_queue` is skipped entirely — engine queues stay shallow and
waiting happens in the ROUTER queue, which is the only place
backpressure can see it.

Admission control is head-of-line backpressure on that bounded queue:
when it is full, `policy="reject"` refuses the newcomer (submit
returns None) while `policy="shed"` accepts it and drops the OLDEST
queued request, recording an honest `Completion(finish_reason="shed")`
— either way every submitted request is accounted for in
`RouterStats` (completed + shed + rejected == submitted), and a
bounded queue is what keeps p99 latency bounded under overload.

Autoscaling closes the loop on the `EngineStats` the engines already
emit. Every `window` router steps the autoscaler reads each live
replica's stats through a `StatsWindow` (windowed deltas, not
since-boot totals) and forms a signal: mean decode utilization
(decode_tokens / decode_steps·slots — deterministic, no wall-clock)
plus total queued work. Scale up when the fleet is saturated and work
is waiting; scale down when it is idle and quiet. Hysteresis comes
from the dead band between `up_util` and `down_util` plus a `cooldown`
of windows after every action. Scale-down never drops work:
the emptiest replica is marked DRAINING (no new dispatches), keeps
stepping until its queue and slots empty, and only then retires — and
a scale-up revives a draining replica (already warm) before paying
for a cold one.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

from .engine import EngineStats, StatsWindow
from .replica import Replica, ReplicaLoad, host_tokens
from .scheduler import Completion


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    window: int = 8             # router steps per autoscale decision
    up_util: float = 0.75       # scale up at/above this mean decode util
    down_util: float = 0.25     # scale down at/below (dead band between)
    cooldown: int = 2           # decision windows skipped after an action

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(f"need 1 <= min_replicas <= max_replicas, got "
                             f"{self.min_replicas}..{self.max_replicas}")
        if self.window < 1:
            raise ValueError(f"window ({self.window}) must be >= 1")
        if not 0.0 <= self.down_util <= self.up_util:
            raise ValueError(f"need 0 <= down_util <= up_util, got "
                             f"{self.down_util} / {self.up_util}")
        if self.cooldown < 0:
            raise ValueError(f"cooldown ({self.cooldown}) must be >= 0")


@dataclasses.dataclass(frozen=True)
class AutoscaleSignal:
    """One decision window's worth of evidence, as the autoscaler sees
    it. Built from windowed EngineStats deltas by the router; built by
    hand in tests (the policy is a pure function of this)."""
    decode_util: float          # mean over live replicas, this window
    queued: int                 # router queue + engine queues right now
    live: int                   # replicas accepting dispatches
    draining: int = 0           # replicas finishing up before retire


class Autoscaler:
    """Hysteresis-banded threshold policy over AutoscaleSignals.

    observe() is called once per decision window and returns "up",
    "down" or None. Scale up only when saturated (util >= up_util)
    AND work is actually waiting; scale down only when idle
    (util <= down_util) AND nothing is queued. Between the thresholds
    nothing happens (dead band), and after any action `cooldown`
    windows are skipped — both are what stop a noisy load from
    flapping the fleet."""

    def __init__(self, acfg: AutoscaleConfig):
        self.acfg = acfg
        self._cooldown = 0

    def observe(self, sig: AutoscaleSignal) -> Optional[str]:
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        a = self.acfg
        if (sig.queued > 0 and sig.decode_util >= a.up_util
                and sig.live < a.max_replicas):
            self._cooldown = a.cooldown
            return "up"
        if (sig.queued == 0 and sig.decode_util <= a.down_util
                and sig.live - 1 >= a.min_replicas):
            self._cooldown = a.cooldown
            return "down"
        return None


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    replicas: int = 1           # initial fleet size (autoscale clamps
                                # it into [min_replicas, max_replicas])
    queue_limit: int = 64       # bounded router queue (backpressure)
    policy: str = "reject"      # queue-full policy: "reject" the
                                # newcomer or "shed" the oldest queued
    replica_queue: Optional[int] = None  # max engine-queue depth per
                                # replica before dispatch skips it;
                                # None = the replica's slot count (one
                                # refill wave deep)
    autoscale: Optional[AutoscaleConfig] = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas ({self.replicas}) must be >= 1")
        if self.queue_limit < 1:
            raise ValueError(f"queue_limit ({self.queue_limit}) must be >= 1")
        if self.policy not in ("reject", "shed"):
            raise ValueError(f"policy must be 'reject' or 'shed', "
                             f"got {self.policy!r}")
        if self.replica_queue is not None and self.replica_queue < 1:
            raise ValueError(f"replica_queue ({self.replica_queue}) "
                             "must be >= 1 (0 would deadlock dispatch)")


@dataclasses.dataclass
class RouterStats:
    """Honest request accounting: every submit ends in exactly one of
    completed / shed / rejected (plus in-flight while running)."""
    submitted: int = 0
    accepted: int = 0
    rejected: int = 0           # refused at the front door (policy=reject)
    shed: int = 0               # accepted then dropped queued (policy=shed)
    dispatched: int = 0
    completed: int = 0
    steps: int = 0
    queue_peak: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    retired: int = 0            # drained replicas actually removed
    replica_peak: int = 0
    # live (non-draining) replica count recorded at every autoscale
    # window — the deterministic trajectory CI gates
    replica_trajectory: list = dataclasses.field(default_factory=list)

    @property
    def shed_rate(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    @property
    def reject_rate(self) -> float:
        return self.rejected / self.submitted if self.submitted else 0.0


def dispatch_cost(load: ReplicaLoad) -> int:
    """Requests ahead of a newcomer minus requests admittable right now
    (see module docstring). Lower is better."""
    return load.queue_depth - load.headroom


@dataclasses.dataclass
class _Queued:
    uid: int
    tokens: list
    max_new: int
    temperature: float
    eos_id: Optional[int]
    arrival_s: float


class Router:
    """Front end over N replicas. `factory(rid)` builds replica `rid`
    on demand — at construction for the initial fleet and again on
    every scale-up (share warmed params/engines inside the closure if
    cold starts matter).

    >>> router = Router(lambda rid: InProcessReplica(
    ...     ServeEngine(cfg, params, ecfg)), RouterConfig(replicas=2))
    >>> router.submit([1, 2, 3], max_new=16)
    >>> done = router.run()       # Completions + shed records, uid order
    """

    def __init__(self, factory: Callable[[int], Replica],
                 rcfg: RouterConfig = None):
        self.rcfg = rcfg or RouterConfig()
        self._factory = factory
        self.replicas: dict[int, Replica] = {}
        self._draining: set[int] = set()
        self._windows: dict[int, StatsWindow] = {}
        self._next_rid = 0
        self.queue: collections.deque[_Queued] = collections.deque()
        self.completions: list[Completion] = []
        self.stats = RouterStats()
        self._uid = 0
        self._rr = 0
        acfg = self.rcfg.autoscale
        self._autoscaler = Autoscaler(acfg) if acfg else None
        n = self.rcfg.replicas
        if acfg:
            n = min(max(n, acfg.min_replicas), acfg.max_replicas)
        for _ in range(n):
            self._add_replica()

    # -- fleet -------------------------------------------------------------

    def _add_replica(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.replicas[rid] = self._factory(rid)
        self._windows[rid] = StatsWindow()
        self.stats.replica_peak = max(self.stats.replica_peak,
                                      len(self.live_rids()))
        return rid

    def live_rids(self) -> list[int]:
        """Replicas accepting dispatches (stable id order)."""
        return [r for r in sorted(self.replicas) if r not in self._draining]

    def _retire_drained(self) -> None:
        for rid in sorted(self._draining):
            rep = self.replicas[rid]
            if not rep.pending:
                rep.close()
                del self.replicas[rid]
                del self._windows[rid]
                self._draining.discard(rid)
                self.stats.retired += 1

    # -- intake + dispatch -------------------------------------------------

    def submit(self, prompt_tokens, max_new: int, *,
               temperature: float = 0.0, eos_id: Optional[int] = None
               ) -> Optional[int]:
        """Returns the request's uid, or None if it was rejected
        (bounded queue full under policy="reject")."""
        self.stats.submitted += 1
        toks = host_tokens(prompt_tokens)     # [S, K] planes: K-tuples
        item = _Queued(uid=self._uid, tokens=toks,
                       max_new=max_new, temperature=temperature,
                       eos_id=eos_id, arrival_s=time.perf_counter())
        self.queue.append(item)
        self._dispatch()        # eager: free capacity takes it right away
        if len(self.queue) > self.rcfg.queue_limit:
            # invariant: the queue held <= limit before this submit and
            # dispatch only shrinks it, so the only possible overflow is
            # by exactly one — the newcomer is still the tail
            if self.rcfg.policy == "reject":
                assert self.queue[-1] is item
                self.queue.pop()
                self.stats.rejected += 1
                return None
            self._shed(self.queue.popleft())
        self.stats.accepted += 1
        self.stats.queue_peak = max(self.stats.queue_peak, len(self.queue))
        self._uid += 1
        return item.uid

    def _shed(self, item: _Queued) -> None:
        """Drop a queued request with an honest record: a Completion
        with finish_reason="shed" and no tokens, timestamped now."""
        now = time.perf_counter()
        self.completions.append(Completion(
            uid=item.uid, prompt_len=len(item.tokens), tokens=[],
            finish_reason="shed", submitted_at=item.arrival_s,
            admitted_at=now, finished_at=now, arrival_s=item.arrival_s))
        self.stats.shed += 1

    def _pick_replica(self) -> Optional[int]:
        best, best_cost = None, None
        for rid in self.live_rids():
            load = self.replicas[rid].load()
            cap = (self.rcfg.replica_queue if self.rcfg.replica_queue
                   is not None else load.slots)
            if load.queue_depth >= cap:
                continue
            cost = dispatch_cost(load)
            if best_cost is None or cost < best_cost:
                best, best_cost = rid, cost
        return best

    def _dispatch(self) -> None:
        while self.queue:
            rid = self._pick_replica()
            if rid is None:
                return          # all replicas at their queue cap: wait
            item = self.queue.popleft()
            self.replicas[rid].submit(
                item.tokens, item.max_new, temperature=item.temperature,
                eos_id=item.eos_id, uid=item.uid, arrival_s=item.arrival_s)
            self.stats.dispatched += 1

    # -- event loop --------------------------------------------------------

    def step(self) -> bool:
        """One router iteration: dispatch what fits, step every busy
        replica once (round-robin rotation), harvest completions,
        retire drained replicas, tick the autoscaler on its window.
        Returns False when no replica made progress (idle)."""
        self._dispatch()
        progressed = False
        rids = sorted(self.replicas)
        n = len(rids)
        for i in range(n):
            rid = rids[(self._rr + i) % n]
            rep = self.replicas[rid]
            if rep.pending:
                progressed = rep.step() or progressed
            for c in rep.poll():
                self.completions.append(c)
                self.stats.completed += 1
        self._rr += 1
        self._retire_drained()
        self.stats.steps += 1
        if (self._autoscaler
                and self.stats.steps % self.rcfg.autoscale.window == 0):
            self._autoscale_tick()
        # freed slots/pages take more of the queue before control returns
        self._dispatch()
        return progressed

    def run(self) -> list[Completion]:
        """Serve until the queue and every replica drain. Returns every
        terminal record — completions AND shed entries — in uid order."""
        while self.pending:
            if not self.step() and not self.queue:
                break
        return sorted(self.completions, key=lambda c: c.uid)

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(r.pending
                                       for r in self.replicas.values())

    def close(self) -> None:
        for rep in self.replicas.values():
            rep.close()
        self.replicas.clear()
        self._draining.clear()

    # -- autoscaling -------------------------------------------------------

    def _autoscale_tick(self) -> None:
        live = self.live_rids()
        utils, queued = [], len(self.queue)
        loads: dict[int, ReplicaLoad] = {}
        for rid in live:
            rep = self.replicas[rid]
            load = rep.load()
            loads[rid] = load
            queued += load.queue_depth
            delta = self._windows[rid].tick(rep.stats())
            utils.append(delta.decode_utilization(load.slots, load.planes))
        sig = AutoscaleSignal(
            decode_util=sum(utils) / len(utils) if utils else 0.0,
            queued=queued, live=len(live), draining=len(self._draining))
        action = self._autoscaler.observe(sig)
        if action == "up":
            if self._draining:
                # a draining replica is warm capacity: un-drain the
                # lowest id instead of paying a cold start
                self._draining.discard(min(self._draining))
            else:
                self._add_replica()
            self.stats.scale_ups += 1
        elif action == "down":
            # drain the emptiest live replica (fewest queued+running,
            # ties to the highest id so replica 0 retires last)
            rid = min(live, key=lambda r: (
                loads[r].queue_depth + loads[r].slots - loads[r].free_slots,
                -r))
            self._draining.add(rid)
            self.stats.scale_downs += 1
        self.stats.replica_peak = max(self.stats.replica_peak,
                                      len(self.live_rids()))
        self.stats.replica_trajectory.append(len(self.live_rids()))

    def engine_totals(self) -> EngineStats:
        """Fleet-wide EngineStats: the sum over live replicas' current
        snapshots (counters AND gauges — fleet totals). Retired
        replicas' counters are gone with them; totals describe the
        replicas still standing."""
        total = EngineStats()
        for rep in self.replicas.values():
            snap = rep.stats()
            for f in dataclasses.fields(total):
                setattr(total, f.name,
                        getattr(total, f.name) + getattr(snap, f.name))
        return total
