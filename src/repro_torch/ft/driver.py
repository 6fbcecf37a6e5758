"""Fault-tolerant training driver (counterpart of ``repro/ft/driver.py``).

Behaviours, testable on one host:

  * **checkpoint/restart**: periodic atomic checkpoints of
    (params, opt_state, data-pipeline state); `TrainDriver.resume()`
    restarts from the latest committed step. Because the data pipeline is
    step-indexed (repro_torch/data), the restarted loss trajectory is
    *bit-identical* to an uninterrupted run — asserted in tests.
  * **preemption simulation**: `preempt_at={step,...}` raises
    `SimulatedPreemption` after the step completes (mimicking a SIGTERM
    between steps); the test harness catches it, builds a fresh driver
    (fresh process stand-in) and resumes.
  * **NaN guard + rollback**: the train step already refuses non-finite
    updates on the device (steps.py skip_nonfinite). The driver counts
    consecutive skips; at `rollback_after` it reloads the last checkpoint
    and continues (fresh data order after the rollback point comes from
    the step index, so no batch is ever silently dropped).
  * **straggler watchdog**: per-step wall times tracked against a rolling
    median; steps slower than `straggler_factor` x median invoke
    `on_straggler` (on a real pod: report the slow host to the job
    controller / trigger hot-spare swap; here: recorded + logged).

A sharded run (``sharded=``, a ``launch/steps.py::ShardedState``) runs
one driver a rank over the same step stream. It saves the one-device
layout: every leaf gathered whole, the first rank writes the npz and
the others wait at a barrier, so the file is the one a single device and
the reference write; a restore cuts each rank's blocks out of it. The
step's metrics are global and the same on every rank, so every rank
makes the same skip and rollback decisions.

The driver is synchronous: one logical step stream, checkpointing on
the step boundary. It passes the step index to the step as a host int,
and reads each step's loss, gradient norm and skip flag on the host:
that read is where the host waits for the device, once a step.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import numpy as np

from repro_torch.checkpoint import CheckpointStore


class SimulatedPreemption(RuntimeError):
    """Raised between steps to model a SIGTERM'd / preempted worker."""

    def __init__(self, step: int):
        super().__init__(f"preempted after step {step}")
        self.step = step


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep_last: int = 3
    rollback_after: int = 3          # consecutive skipped steps -> rollback
    max_rollbacks: int = 2           # bound: persistently-bad data must not
                                     # rollback-loop forever; after this many
                                     # the driver skips onward and reports
    straggler_factor: float = 3.0    # step > factor * rolling median
    straggler_window: int = 32
    log_every: int = 10


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    gnorm: float
    wall_s: float
    skipped: bool
    rolled_back: bool = False
    straggler: bool = False


class TrainDriver:
    """Owns (params, opt_state, step index) and runs the FT loop.

    step_fn(params, opt_state, batch, step) -> (params, opt_state, metrics)
    pipeline(step) -> batch
    """

    def __init__(self, step_fn: Callable, pipeline, params, opt_state,
                 ft: FTConfig, *, start_step: int = 0,
                 metadata: dict | None = None,
                 on_straggler: Callable[[StepRecord], None] | None = None,
                 log: Callable[[str], None] = print, sharded=None):
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.params = params
        self.opt_state = opt_state
        self.step = start_step
        self.ft = ft
        self.store = CheckpointStore(ft.ckpt_dir, keep_last=ft.keep_last)
        self.metadata = metadata or {}
        self.on_straggler = on_straggler
        self.log = log
        self.sharded = sharded
        self.history: list[StepRecord] = []
        self._consecutive_skips = 0
        self._rollbacks = 0
        self._wall_times: list[float] = []

    # -- checkpoint glue -------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def save(self):
        meta = dict(self.metadata, step=self.step,
                    pipeline=self.pipeline.state(self.step))
        tree = self._state_tree()
        if self.sharded is None:
            self.store.save(self.step, tree, metadata=meta)
            return
        tree = self.sharded.whole(tree)        # every rank gathers
        if tree is not None:
            self.store.save(self.step, tree, metadata=meta)
        self.sharded.barrier()

    @staticmethod
    def _restore_latest(store, tree, sharded):
        if sharded is None:
            return store.restore_latest(tree)
        return store.restore_latest(sharded.template(tree),
                                    cut=lambda full: sharded.local(full,
                                                                   tree))

    @classmethod
    def resume(cls, step_fn, pipeline, params_template, opt_template,
               ft: FTConfig, **kw):
        """Build a driver from the latest committed checkpoint; falls back
        to the provided templates at step 0 if none exists. Templates may
        be freshly-initialized tensors (their values are overwritten; their
        dtypes and devices are kept); sharded, each rank's blocks."""
        store = CheckpointStore(ft.ckpt_dir, keep_last=ft.keep_last)
        tmpl = {"params": params_template, "opt_state": opt_template}
        got = cls._restore_latest(store, tmpl, kw.get("sharded"))
        if got is None:
            return cls(step_fn, pipeline, params_template, opt_template, ft,
                       start_step=0, **kw)
        step, tree, meta = got
        drv = cls(step_fn, pipeline, tree["params"], tree["opt_state"], ft,
                  start_step=int(meta["extra"]["step"]), **kw)
        drv.log(f"[ft] resumed from checkpoint step {drv.step}")
        return drv

    # -- rollback ---------------------------------------------------------
    def _rollback(self) -> bool:
        got = self._restore_latest(self.store, self._state_tree(),
                                   self.sharded)
        if got is None:
            self.log("[ft] rollback requested but no checkpoint exists")
            return False
        step, tree, meta = got
        self.params, self.opt_state = tree["params"], tree["opt_state"]
        self.step = int(meta["extra"]["step"])
        self._consecutive_skips = 0
        self.log(f"[ft] rolled back to step {self.step}")
        return True

    # -- watchdog ----------------------------------------------------------
    def _check_straggler(self, rec: StepRecord):
        self._wall_times.append(rec.wall_s)
        w = self._wall_times[-self.ft.straggler_window:]
        if len(w) >= 8:
            med = statistics.median(w)
            if rec.wall_s > self.ft.straggler_factor * med:
                rec.straggler = True
                if self.on_straggler:
                    self.on_straggler(rec)
                self.log(f"[ft] straggler step {rec.step}: "
                         f"{rec.wall_s:.3f}s vs median {med:.3f}s")

    # -- main loop ----------------------------------------------------------
    def run(self, n_steps: int, *, preempt_at: set[int] | None = None
            ) -> list[StepRecord]:
        """Run up to `n_steps` more steps. Raises SimulatedPreemption if the
        step index lands in `preempt_at` (checkpointing first, as a real
        SIGTERM handler would)."""
        preempt_at = preempt_at or set()
        target = self.step + n_steps
        while self.step < target:
            batch = self.pipeline(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.step)
            loss = float(metrics["loss"])
            wall = time.perf_counter() - t0
            skipped = bool(int(metrics.get("skipped", 0)))
            rec = StepRecord(self.step, loss, float(metrics["gnorm"]),
                             wall, skipped)
            self._check_straggler(rec)
            self.history.append(rec)

            if skipped:
                self._consecutive_skips += 1
                self.log(f"[ft] step {self.step}: non-finite update skipped "
                         f"({self._consecutive_skips} consecutive)")
                if (self._consecutive_skips >= self.ft.rollback_after
                        and self._rollbacks < self.ft.max_rollbacks):
                    if self._rollback():
                        self._rollbacks += 1
                        rec.rolled_back = True
                        continue
            else:
                self._consecutive_skips = 0

            self.step += 1
            if self.ft.log_every and self.step % self.ft.log_every == 0:
                self.log(f"step {self.step:6d} loss {loss:.4f} "
                         f"gnorm {rec.gnorm:.3f} {wall*1e3:.0f}ms")
            if self.step % self.ft.ckpt_every == 0:
                self.save()
            if self.step in preempt_at:
                self.save()          # graceful-shutdown checkpoint
                raise SimulatedPreemption(self.step)
        return self.history

    # -- metrics -----------------------------------------------------------
    def losses(self) -> np.ndarray:
        return np.asarray([r.loss for r in self.history])
