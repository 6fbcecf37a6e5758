"""Continuous-batching serve subsystem (slot contract).

`ServeEngine` (engine.py) owns the per-slot device cache and the
on-device decode chunks; `TokenBudgetScheduler` (scheduler.py) owns
host-side request/slot bookkeeping and the prompt bucketing policy.
"""
from .engine import (EngineConfig, EngineStats, ServeEngine, sample_tokens,
                     sample_tokens_indexed)
from .scheduler import (Completion, FifoScheduler, Request, StepPlan,
                        TokenBudgetScheduler, bucket_len)

__all__ = [
    "Completion",
    "EngineConfig",
    "EngineStats",
    "FifoScheduler",
    "Request",
    "ServeEngine",
    "StepPlan",
    "TokenBudgetScheduler",
    "bucket_len",
    "sample_tokens",
    "sample_tokens_indexed",
]
