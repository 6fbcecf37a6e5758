"""Named spans of the program's phases, on the profiler's clock.

The port's one span system (the JAX package has no counterpart). The
serve engine, the train step and the attention branch open a span around
each of their phases:

    serve.step         one ServeEngine.step()
      serve.admit      admission: scheduling, page reservation, prefill, insert
        serve.prefill  the ragged prefill through its first-token pull
        serve.insert   the slot insert through its sync
      serve.pages      page growth and the page-table upload
      serve.decode     a decode chunk through its token pull
        serve.prefill_chunk  one prefill chunk (token-budget schedule)
      serve.harvest    harvest, evictions and completions
    train.step         one train step
      train.forward    the loss
      train.backward   the gradients (under remat "block": the recompute too)
      train.reduce     the gradient reduction (on a mesh)
      train.optimizer  clip, compression, AdamW, frozen-leaf restore,
                       non-finite select
    model.attention    one attention branch of one layer

With no profiler recording, ``span(name)`` returns one shared no-op
object: one C call, and nothing is recorded. While a ``torch.profiler``
run records, a span opens ``record_function("repro." + name)``, so the
range lands in the same trace as the device operations and each idle gap
can be put down to the phase the host was in. It also marks its entry
and exit in stream order (a timing CUDA event pair on the current
stream once CUDA is initialised, ``time.perf_counter`` before that) and
keeps ``(name, parent, marks)``; the parent is the innermost span open
on the same thread (autograd's backward runs on a thread of its own).

``device_ms()`` resolves the marks into ``{key: (count, summed ms)}``,
keyed by name and by ``parent/name``; synchronise the device first.
``reset()`` forgets them. A span never syncs, allocates no device
memory, and does not change what the code inside it computes.
"""
from __future__ import annotations

import threading
import time

import torch

_profiling = torch.autograd._profiler_enabled


class _Off:
    """The span while no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _mark():
    if torch.cuda.is_initialized():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


class _Span:
    __slots__ = ("name", "parent", "_range", "t0", "t1")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self._range = torch.profiler.record_function("repro." + self.name)
        self._range.__enter__()
        self.t0 = _mark()
        return self

    def __exit__(self, *exc):
        # one kind of mark at both ends: the exit takes the entry's
        self.t1 = _mark() if isinstance(self.t0, torch.cuda.Event) \
            else time.perf_counter()
        self._range.__exit__(*exc)
        self._range = None
        _open().pop()
        with _lock:
            _pending.append(self)
        return False

    def ms(self) -> float:
        if isinstance(self.t0, torch.cuda.Event):
            return self.t0.elapsed_time(self.t1)
        return 1e3 * (self.t1 - self.t0)


_local = threading.local()
_lock = threading.Lock()
_pending: list[_Span] = []
_totals: dict[str, tuple[int, float]] = {}


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context manager around one phase named ``name``; the shared
    no-op ``OFF`` unless a profiler is recording."""
    return _Span(name) if _profiling() else OFF


def device_ms() -> dict[str, tuple[int, float]]:
    """{name or parent/name: (spans, summed ms between their marks)} of
    every span closed since the last ``reset()``. The caller synchronises
    the device first."""
    with _lock:
        done = [(s, s.ms()) for s in _pending]
        _pending.clear()
        for s, ms in done:
            for key in (s.name,) if s.parent is None else \
                    (s.name, f"{s.parent}/{s.name}"):
                n, total = _totals.get(key, (0, 0.0))
                _totals[key] = (n + 1, total + ms)
        return dict(_totals)


def reset() -> None:
    """Forget every recorded span."""
    with _lock:
        _pending.clear()
        _totals.clear()
