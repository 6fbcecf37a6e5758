"""Continuous-batching serve subsystem.

`ServeEngine` (engine.py) owns the device cache — a shared page pool
with per-slot page tables by default, per-slot rings via
`EngineConfig(cache="slot")` — and the on-device decode chunks;
`TokenBudgetScheduler` (scheduler.py) owns host-side request/slot
bookkeeping, the prompt bucketing policy, and the token-budget step
planner that interleaves chunked prefill with decode
(`EngineConfig(chunk_prefill=N)`); `PagePool` (paging.py) owns page
allocation, worst-case reservations, and refcounted prefix chains.
"""
from .engine import (EngineConfig, EngineStats, ServeEngine, StatsWindow,
                     sample_tokens, sample_tokens_indexed)
from .scheduler import (Completion, FifoScheduler, Request, StepPlan,
                        TokenBudgetScheduler, bucket_len)

__all__ = [
    "Completion",
    "EngineConfig",
    "EngineStats",
    "FifoScheduler",
    "Request",
    "ServeEngine",
    "StatsWindow",
    "StepPlan",
    "TokenBudgetScheduler",
    "bucket_len",
    "sample_tokens",
    "sample_tokens_indexed",
]
