"""Where the time of one ``glu_2d`` TMA launch goes, phase by phase.

    PYTHONPATH=src python -m repro_torch.kernels.glu_phases

Needs the card. Builds the kernel library with ``-DREPRO_GLU_PHASES``
(a separate library: the served one has no stamps), launches the
``tma_wgmma`` variant (bf16) and the ``tma_f32`` variant (f32) at the
served FFN's shapes with the L2 cache overwritten before each launch,
and reads the %globaltimer stamps that thread 0 of every CTA wrote (ns).
Prints a line with the library's build seconds (a cached build loads in
well under one), then one JSON line per shape: the median over launches
of the mean over CTAs of each phase, and of the launch's span from its
first CTA's start to its last CTA's end. Then one ``glu_f32_sweep`` line
per f32 shape of PERF.md's kernel table: ``tma_f32``'s span at each K
split the launch takes (the split ``_glu_f32_geometry`` picks is
``geometry[-1]``), and the median CUDA-event time of one launch (the card
kept busy while the host enqueues it), L2 overwritten before it, of
``tma_f32`` at that split and of ``simt_f32``, the first slice's f32
kernel, on the same inputs.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi

PHASE_FLAG = ("-DREPRO_GLU_PHASES",)
# the stamp slots of csrc/epilogue.cu (GLU_PHASE): 0 CTA start, 1 the
# producer's last TMA issue, 2 the first stage landed, 3 the K loop done,
# 4 the partials parked, 5 past the first cluster barrier, 6 the epilogue
# stored, 7 past the second cluster barrier. In the f32 kernel (tma_f32),
# which pushes its partials and has one barrier after the K loop: 4 the
# slices parked and every destination ready, 5 the partials pushed and past
# the cluster barrier, 6 = 7 the owned groups reduced and stored.
# (phase, from slot, to slot), each a mean over CTAs
PHASES = (("to_last_issue", 0, 1), ("to_first_stage", 0, 2),
          ("k_loop", 0, 3), ("park_partials", 3, 4),
          ("cluster_barrier_1", 4, 5), ("reduce_epilogue_store", 5, 6),
          ("cluster_barrier_2", 6, 7))
# (M, K, N, dtype): qwen3-0.6b's FFN and a short K; at f32 also its TP 4
# decode shard and qwen2.5-3b's TP 4 prefill shard
SHAPES = ((2, 1024, 3072, "bfloat16"), (128, 1024, 3072, "bfloat16"),
          (256, 1024, 3072, "bfloat16"), (2, 64, 3072, "bfloat16"),
          (128, 64, 3072, "bfloat16"), (2, 1024, 3072, "float32"),
          (2, 1024, 768, "float32"), (128, 1024, 3072, "float32"),
          (128, 2048, 2752, "float32"), (1024, 1024, 3072, "float32"))
# the f32 shapes of PERF.md's kernel table: decode (qwen3 full width, TP
# 2 / 4; qwen2.5-3b TP 4, hymba TP 2), the sharded-train shards, prefill
F32_TABLE = ((2, 1024, 3072), (2, 1024, 1536), (2, 1024, 768),
             (2, 2048, 2752), (2, 1600, 2752), (64, 1024, 1536),
             (32, 1024, 3072), (128, 1024, 768), (64, 1600, 2752),
             (128, 2048, 2752), (100, 1600, 2752), (128, 1024, 1536),
             (128, 1024, 3072), (256, 1024, 3072), (1024, 1024, 3072))
SPLITS = (1, 2, 4, 8)
# cycles the card spins (~0.1 ms) before a timed launch's start event, so
# that it is still busy while the host enqueues the launch: the events then
# time the kernel, not the host's launch latency
BUSY_CYCLES = 200_000
MAX_CTAS = 8192


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phases_of(stamps: np.ndarray) -> dict:
    """Phase durations (ns) of one launch from its [ctas, 8] stamps."""
    a = stamps[stamps[:, 0] > 0].astype(np.int64)
    t0 = a[:, 0].min()
    out = {name: float(np.mean(a[:, j] - a[:, i])) for name, i, j in PHASES}
    out.update(ctas=int(len(a)), span=float(a[:, 7].max() - t0),
               start_spread=float(a[:, 0].max() - t0))
    return out


def operands(m: int, k: int, n: int, dtype: str):
    """x, w_gate, w_up, the silu table's params, out, and the C side's
    table arguments, made from a seed."""
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k)
    x = torch.randn((m, k), generator=gen, device=dev).to(dt)
    wg = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(dt)
    wu = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(dt)
    table = epi.table_for("silu", 4.0, 32)
    spec = epi.TableSpec.of(table)
    p = torch.as_tensor(table.windows, dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=dt, device=dev)
    return x, wg, wu, p, out, epi._kernel_args("silu", spec, p, x)


def launch(lib, ops, variant: str, split: int) -> int:
    """One glu_2d launch of ``variant`` past the wrapper's choice (it
    counts no launch); returns the C side's code."""
    x, wg, wu, p, out, args = ops
    (m, k), n = x.shape, wg.shape[1]
    return lib.repro_glu_2d(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                            p.data_ptr(), out.data_ptr(), m, n, k, *args,
                            epi._GLU_VARIANT_IDS[variant], split,
                            torch.cuda.current_stream().cuda_stream)


def timed(lib, ops, variant: str, split: int, flush, events=None) -> None:
    """``launch`` with L2 overwritten before it (between ``events``, if
    given, behind BUSY_CYCLES); waits for its end and raises on a refused
    launch."""
    flush.zero_()
    torch.cuda.synchronize()
    if events:
        torch.cuda._sleep(BUSY_CYCLES)
        events[0].record()
    rc = launch(lib, ops, variant, split)
    if events:
        events[1].record()
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"glu_2d ({variant}) launch failed: cudaError {rc}")


def measure(lib, m: int, k: int, n: int, dtype: str = "bfloat16",
            launches: int = 8, split: int | None = None) -> dict:
    """The phases of ``launches`` launches of the TMA variant of
    ``dtype`` (tma_f32 at ``split``, by default the wrapper's)."""
    ops = operands(m, k, n, dtype)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    f32 = dtype == "float32"
    if split is None:
        split = epi._glu_f32_geometry(m, n, k)[-1] if f32 else 0
    buf = (ctypes.c_ulonglong * (MAX_CTAS * 8))()
    if lib.repro_glu_phases(buf, MAX_CTAS) != 0:   # clears earlier stamps
        raise RuntimeError("clearing the phase stamps failed")
    runs = []
    for _ in range(launches):
        timed(lib, ops, "tma_f32" if f32 else "tma_wgmma", split, flush)
        rc = lib.repro_glu_phases(buf, MAX_CTAS)
        if rc != 0:
            raise RuntimeError(f"reading the phase stamps failed: {rc}")
        runs.append(phases_of(np.frombuffer(buf, dtype=np.uint64)
                              .reshape(MAX_CTAS, 8)))
    return {key: statistics.median(r[key] for r in runs) for key in runs[0]}


def event_ms(lib, ops, variant: str, split: int, launches: int = 8) -> float:
    """Median CUDA-event time (ms) of one launch, L2 overwritten before
    each."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    times = []
    for _ in range(launches + 1):        # the first launch warms up
        timed(lib, ops, variant, split, flush, events)
        times.append(events[0].elapsed_time(events[1]))
    return statistics.median(times[1:])


def f32_sweep(lib, m: int, k: int, n: int) -> dict:
    """tma_f32's span (ns) at every split of SPLITS its K blocks allow, and
    the event times of tma_f32 (the wrapper's split) and simt_f32."""
    geometry = epi._glu_f32_geometry(m, n, k)
    kb = -(-k // geometry[2])
    spans = {s: measure(lib, m, k, n, "float32", split=s)["span"]
             for s in SPLITS if s <= kb}
    ops = operands(m, k, n, "float32")
    return {"geometry": list(geometry), "span_ns": spans,
            "events_ms": {"tma_f32": event_ms(lib, ops, "tma_f32",
                                              geometry[-1]),
                          "simt_f32": event_ms(lib, ops, "simt_f32", 0)}}


def load() -> ctypes.CDLL:
    """The kernel library with the phase stamps compiled in (built on
    first call)."""
    lib = _build.library(PHASE_FLAG)
    lib.repro_glu_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.repro_glu_phases.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("glu_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    lib = load()
    card = card_line()
    # this build compiles epilogue.cu as one unit (kernels/_build.py)
    print(json.dumps({"phase": "glu_phases_build", "card": card,
                      "build_s": time.perf_counter() - t0}), flush=True)
    for m, k, n, dtype in SHAPES:
        print(json.dumps({"phase": "glu_phases", "card": card,
                          "shape": [m, k, n], "dtype": dtype, "unit": "ns",
                          **measure(lib, m, k, n, dtype)}), flush=True)
    for m, k, n in F32_TABLE:
        print(json.dumps({"phase": "glu_f32_sweep", "card": card,
                          "shape": [m, k, n], **f32_sweep(lib, m, k, n)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
