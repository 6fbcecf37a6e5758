"""Continuous-batching serve subsystem.

`ServeEngine` (engine.py) owns the device cache — a shared page pool
with per-slot page tables by default, per-slot rings via
`EngineConfig(cache="slot")` — and the on-device decode chunks;
`TokenBudgetScheduler` (scheduler.py) owns host-side request/slot
bookkeeping, the prompt bucketing policy, and the token-budget step
planner that interleaves chunked prefill with decode
(`EngineConfig(chunk_prefill=N)`); `PagePool` (paging.py) owns page
allocation, worst-case reservations, and refcounted prefix chains.

The multi-replica tier sits above all of that: `Router` (router.py)
spreads a request stream over N replicas behind the `Replica`
protocol (replica.py) with load-aware dispatch, bounded-queue
backpressure, and stats-driven autoscaling.
"""
from .engine import (EngineConfig, EngineStats, ServeEngine, StatsWindow,
                     sample_tokens, sample_tokens_indexed)
from .replica import (InProcessReplica, ProcessReplica, Replica,
                      ReplicaLoad, ReplicaSpec)
from .router import (AutoscaleConfig, Autoscaler, AutoscaleSignal,
                     Router, RouterConfig, RouterStats, dispatch_cost)
from .scheduler import (Completion, FifoScheduler, Request, StepPlan,
                        TokenBudgetScheduler, bucket_len)

__all__ = [
    "AutoscaleConfig",
    "AutoscaleSignal",
    "Autoscaler",
    "Completion",
    "EngineConfig",
    "EngineStats",
    "FifoScheduler",
    "InProcessReplica",
    "ProcessReplica",
    "Replica",
    "ReplicaLoad",
    "ReplicaSpec",
    "Request",
    "Router",
    "RouterConfig",
    "RouterStats",
    "ServeEngine",
    "StatsWindow",
    "StepPlan",
    "TokenBudgetScheduler",
    "bucket_len",
    "dispatch_cost",
    "sample_tokens",
    "sample_tokens_indexed",
]
