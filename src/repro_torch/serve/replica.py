"""Replica abstraction for the multi-replica serving tier (counterpart of
``repro/serve/replica.py``).

A *replica* is one independent ``ServeEngine`` behind a small uniform
surface the router (router.py) can drive without knowing where the
engine lives:

    submit(tokens, max_new, *, temperature, eos_id, uid, arrival_s)
    step() -> bool          # advance one engine iteration
    poll() -> [Completion]  # drain finished requests
    load() -> ReplicaLoad   # dispatch-cost inputs (queue/slots/pages)
    stats() -> EngineStats  # cumulative snapshot (gauges filled)
    pending -> bool
    close()

``InProcessReplica`` wraps an engine in the router's own process — the
baseline mode, stepped round-robin by the router; in-process replicas
share the device and, given the same compute-cast ``params`` tree, the
same weight tensors (no copies: ``launch/serve.py::serve_routed`` casts
once). ``ProcessReplica`` runs the engine in a spawned worker process
behind the SAME protocol: the worker imports torch fresh, opens its own
CUDA context on the card (or serves on the CPU), and builds its model
from a ``ReplicaSpec`` (params are never pickled). RPC is synchronous
(one tagged request/reply per call), as in the reference.

``ReplicaSpec(model_parallel=N)`` (N > 1) makes the replica a
tensor-parallel group of N spawned rank processes on a (1, N) mesh
(``ServeEngine(mesh=)``): rank 0 holds the pipe, receives each RPC and
broadcasts it to the other ranks, every rank applies it to its own
engine, and rank 0 answers. The group stays inside the replica: the
router sees one replica. ``dist_backend`` is the group's backend
(default ``nccl`` on CUDA, ``gloo`` on the CPU; ranks sharing one card
need ``gloo``).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import shutil
import tempfile
from typing import Protocol

import numpy as np

from .engine import EngineConfig, EngineStats, ServeEngine
from .scheduler import Completion


@dataclasses.dataclass(frozen=True)
class ReplicaLoad:
    """Dispatch-cost inputs for one replica, read at routing time.

    ``headroom`` is the number of requests the replica could admit right
    now: free slots, further capped by free pages when the cache is
    paged (a worst-case request needs ``pages_per_slot`` pages)."""
    queue_depth: int            # requests waiting inside the engine
    free_slots: int
    slots: int
    pages_free: int = 0         # PagePool.available(); 0 for slot cache
    pages_per_slot: int = 0     # 0: not paged (pages don't bind)
    pending: bool = False
    planes: int = 1             # codebook count K: the engine's token
                                # counters count plane tokens, so
                                # utilization denominators scale by K

    @property
    def headroom(self) -> int:
        slots = self.free_slots
        if self.pages_per_slot > 0:
            slots = min(slots, self.pages_free // self.pages_per_slot)
        return slots


class Replica(Protocol):
    """Structural protocol — see module docstring for the contract."""

    def submit(self, prompt_tokens, max_new: int, *, temperature: float,
               eos_id, uid, arrival_s) -> int: ...
    def step(self) -> bool: ...
    def poll(self) -> list: ...
    def load(self) -> ReplicaLoad: ...
    def stats(self) -> EngineStats: ...
    @property
    def pending(self) -> bool: ...
    def close(self) -> None: ...


def _load_of(engine: ServeEngine) -> ReplicaLoad:
    return ReplicaLoad(
        queue_depth=len(engine.sched.queue),
        free_slots=len(engine.sched.free_slots()),
        slots=engine.ecfg.slots,
        pages_free=engine._pool.available() if engine.paged else 0,
        pages_per_slot=engine._n_per_slot if engine.paged else 0,
        pending=engine.sched.pending,
        planes=engine.K)


def host_tokens(prompt_tokens) -> list:
    """A prompt as host tokens: ints, or K-tuples of ints for [S, K]
    codebook planes. Takes lists, numpy arrays and tensors (on any
    device), so nothing but Python ints crosses a pipe."""
    if hasattr(prompt_tokens, "cpu"):           # a tensor
        prompt_tokens = prompt_tokens.cpu().numpy()
    arr = np.asarray(prompt_tokens)
    if arr.ndim == 2:       # [S, K] multi-codebook: keep the planes
        return [tuple(int(x) for x in row) for row in arr]
    return [int(t) for t in arr.reshape(-1)]


class InProcessReplica:
    """One ServeEngine in the router's process. step() runs one engine
    iteration (admission + one decode/prefill chunk round)."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine

    def submit(self, prompt_tokens, max_new: int, *, temperature: float = 0.0,
               eos_id=None, uid=None, arrival_s=None) -> int:
        return self.engine.submit(prompt_tokens, max_new,
                                  temperature=temperature, eos_id=eos_id,
                                  uid=uid, arrival_s=arrival_s)

    def step(self) -> bool:
        return self.engine.step()

    def poll(self) -> list:
        done, self.engine.completions = self.engine.completions, []
        return done

    def load(self) -> ReplicaLoad:
        return _load_of(self.engine)

    def stats(self) -> EngineStats:
        return self.engine.snapshot()

    @property
    def pending(self) -> bool:
        return self.engine.sched.pending

    def close(self) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Everything a worker process needs to build its engine itself.
    Params are MATERIALIZED in the worker (never pickled across the
    pipe), from ``seed`` on ``device``. ``model_parallel > 1`` serves
    through a tensor-parallel group of that many ranks inside the replica
    (``dist_backend``: None gives ``nccl`` on CUDA, ``gloo`` on the
    CPU)."""
    arch: str = "qwen3-0.6b"
    smoke: bool = True
    seed: int = 0
    bf16: bool = True
    model_parallel: int = 1
    engine: dict = dataclasses.field(default_factory=dict)  # EngineConfig kwargs
    device: str = "cuda"
    dist_backend: str | None = None

    @property
    def backend(self) -> str:
        from repro_torch.launch import mesh as mesh_mod
        return self.dist_backend or mesh_mod.default_backend(self.device)


def _build_engine(spec: ReplicaSpec, rank: int = 0,
                  init_method: str | None = None) -> ServeEngine:
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M

    device, mesh = spec.device, None
    if spec.model_parallel > 1:
        device = mesh_mod.init_distributed(
            rank, spec.model_parallel, backend=spec.backend,
            device=spec.device, init_method=init_method)
        mesh = mesh_mod.make_host_mesh(1, spec.model_parallel,
                                       device=device.type)
    cfg = registry.get(spec.arch, smoke=spec.smoke)
    params = M.materialize_params(cfg, seed=spec.seed, device=device)
    if spec.bf16:
        def cast(t):
            if isinstance(t, dict):
                return {k: cast(v) for k, v in t.items()}
            return t.to(torch.bfloat16) if t.is_floating_point() else t
        params = cast(params)
    return ServeEngine(cfg, params, EngineConfig(**spec.engine), mesh=mesh,
                       device=device)


def _apply(engine: ServeEngine, op: str, payload):
    """One RPC on ``engine``: (reply tag, value)."""
    if op == "submit":
        return "submit", engine.submit(
            payload["tokens"], payload["max_new"],
            temperature=payload["temperature"], eos_id=payload["eos_id"],
            uid=payload["uid"], arrival_s=payload["arrival_s"])
    if op == "step":
        return "step", engine.step()
    if op == "poll":
        done, engine.completions = engine.completions, []
        return "poll", [dataclasses.asdict(c) for c in done]
    if op == "load":
        return "load", dataclasses.asdict(_load_of(engine))
    if op == "stats":
        return "stats", dataclasses.asdict(engine.snapshot())
    if op == "close":
        return "close", None
    return "error", f"unknown op {op!r}"          # defensive


def _worker_main(conn, spec: ReplicaSpec, rank: int = 0,
                 init_method: str | None = None) -> None:
    """Synchronous RPC loop around one engine (spawned process). A failed
    build is reported to the parent as ("error", message). In a TP group
    (``spec.model_parallel > 1``) rank 0 holds ``conn`` and broadcasts
    each request to the other ranks (``conn`` None), which apply it to
    their engines in the same order and do not answer."""
    tp = spec.model_parallel > 1
    try:
        engine = _build_engine(spec, rank, init_method)
    except Exception as e:                      # the parent raises it
        if conn is None:
            raise
        conn.send(("error", f"engine build failed: {e!r}"))
        return
    if conn is not None:
        conn.send(("ready", None))
    import torch.distributed as dist
    while True:
        msg = [conn.recv() if conn is not None else None]
        if tp:
            dist.broadcast_object_list(msg, src=0)
        op, payload = msg[0]
        reply = _apply(engine, op, payload)
        if conn is not None:
            conn.send(reply)
        if op == "close":
            break
    if tp:
        dist.destroy_process_group()


class ProcessReplica:
    """A ServeEngine in a spawned worker process, same protocol as
    InProcessReplica. ``spawn`` (not fork): a CUDA context cannot be
    forked; the worker opens its own on the same card. The kernel
    library is built before the worker starts, so the worker loads the
    parent's build instead of compiling its own.

    ``pending`` is mirrored host-side (submits minus polled completions)
    so the router's idle checks cost no RPC. With ``model_parallel = N >
    1`` the replica spawns N rank processes (a file store under a
    temporary directory joins them); rank 0 is the one spoken to."""

    def __init__(self, spec: ReplicaSpec):
        n = spec.model_parallel
        if n < 1:
            raise ValueError(f"model_parallel must be >= 1, got {n}")
        self._store = None
        init_method = None
        if n > 1:
            from repro_torch.launch import mesh as mesh_mod
            mesh_mod.check_backend(spec.backend, spec.device, n)
            self._store = tempfile.mkdtemp(prefix="replica_tp_")
            init_method = "file://" + os.path.join(self._store, "store")
        if str(spec.device).startswith("cuda"):
            from repro_torch.kernels import _build
            _build.build()
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._procs = [ctx.Process(
            target=_worker_main,
            args=(child if r == 0 else None, spec, r, init_method),
            daemon=True) for r in range(n)]
        self._proc = self._procs[0]
        for proc in self._procs:
            proc.start()
        child.close()
        self._in_flight = 0
        self._closed = False
        tag, val = self._conn.recv()            # blocks until model built
        if tag != "ready":
            self._stop()
            raise RuntimeError(f"replica worker: {val}")

    def _rpc(self, op: str, payload=None):
        self._conn.send((op, payload))
        tag, val = self._conn.recv()
        if tag == "error":
            raise RuntimeError(f"replica worker: {val}")
        assert tag == op, (tag, op)
        return val

    def submit(self, prompt_tokens, max_new: int, *, temperature: float = 0.0,
               eos_id=None, uid=None, arrival_s=None) -> int:
        uid = self._rpc("submit", {
            "tokens": host_tokens(prompt_tokens), "max_new": int(max_new),
            "temperature": float(temperature), "eos_id": eos_id,
            "uid": uid, "arrival_s": arrival_s})
        self._in_flight += 1
        return uid

    def step(self) -> bool:
        return self._rpc("step")

    def poll(self) -> list:
        done = [Completion(**d) for d in self._rpc("poll")]
        self._in_flight -= len(done)
        return done

    def load(self) -> ReplicaLoad:
        return ReplicaLoad(**self._rpc("load"))

    def stats(self) -> EngineStats:
        return EngineStats(**self._rpc("stats"))

    @property
    def pending(self) -> bool:
        return self._in_flight > 0

    @property
    def exitcode(self):
        """The workers' exit code once all have ended (None while one is
        alive): the first nonzero one, else 0."""
        codes = [p.exitcode for p in self._procs]
        if any(c is None for c in codes):
            return None
        return next((c for c in codes if c), 0)

    def _stop(self) -> None:
        for proc in self._procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        if self._store is not None:
            shutil.rmtree(self._store, ignore_errors=True)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._rpc("close")
        except (BrokenPipeError, EOFError, OSError):
            pass
        self._conn.close()
        self._stop()
