"""Where the time of one ``glu_2d`` TMA launch goes, phase by phase.

    PYTHONPATH=src python -m repro_torch.kernels.glu_phases

Needs the card. Builds the kernel library with ``-DREPRO_GLU_PHASES``
(a separate library: the served one has no stamps), launches the TMA
variant the wrapper picks (bf16 ``tma_wgmma_gemm`` from ``GLU_GEMM_ROWS``
rows at K up to ``GLU_GEMM_MAX_K``, else ``tma_wgmma``; f32 ``tma_f32``)
at the served FFN's and the train step's shapes with the L2 cache
overwritten before each launch, and reads the %globaltimer stamps that
thread 0 of every CTA wrote (ns). Prints a line with the library's build
seconds (a cached build loads in well under one), then one JSON line per
shape: the median over launches of the mean over CTAs of each phase, and
of the launch's span from its first CTA's start to its last CTA's end.
``tma_wgmma_gemm``'s lines (``glu_phases`` with ``"variant":
"tma_wgmma_gemm"``) give each phase by the tile's place in its CTA's walk:
its first stage landed (from the CTA's start), its K loop (from that),
its epilogue, and the CTAs that ran that many tiles.
Then the ``glu_bf16_sweep`` lines: at qwen3-0.6b's width (K = 1024, N =
3072) and M = 128, 256, 384, 512, 1024, the median CUDA-event time of one
launch (the card kept busy while the host enqueues it), L2 overwritten
before it, of both bf16 TMA kernels on the same inputs, and the
``glu_bf16_crossover`` line: ``GLU_GEMM_ROWS`` as the sweep measures it
(``crossover``: the lowest swept M from which ``tma_wgmma_gemm`` is the
faster at every swept M, kept within (128, 512]; uncapped beside it)
beside the value in the tree, and ``glu_bf16_train`` lines: the same two
event times at the other bf16 train shapes (BF16_TRAIN). Then the K
sweep: ``glu_bf16_k_sweep`` lines, the same two times at M = 1024 and
each N of BF16_K_SWEEP_N over BF16_K_SWEEP_K, and for each N a
``glu_bf16_k_crossover`` line: the largest swept K up to which
``tma_wgmma_gemm`` is the faster at every swept K, beside
``GLU_GEMM_MAX_K``. Then ``glu_bf16_split``: ``tma_wgmma_gemm`` at split
1 and at split 2, and ``tma_wgmma``, where the geometry picks split 2 on
the main path. Then one ``glu_f32_sweep`` line
per f32 shape of PERF.md's kernel table: ``tma_f32``'s span at each K
split the launch takes (the split ``_glu_f32_geometry`` picks is
``geometry[-1]``), and the event times of ``tma_f32`` at that split and
of ``simt_f32``, the first slice's f32 kernel, on the same inputs.
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
# tma_wgmma_gemm's stamps (csrc/epilogue.cu GEMM_PHASE_SLOTS a CTA): 0
# start, 1 the producer's last issue, 2 the last consumer's end, then per
# tile of the CTA's walk (GEMM_PHASE_TILES): its first stage landed, its K
# loop done, its epilogue stored
GEMM_SLOTS, GEMM_TILES = 64, 16
# (M, K, N, dtype): qwen3-0.6b's FFN and a short K; at bf16 also the train
# step's shapes (qwen3, TRAIN_GLU_TIMED's four in chip_smoke.py) and a
# sharded qwen3 rank's (tma_wgmma_gemm); at f32 also its TP 4 decode shard
# and qwen2.5-3b's TP 4 prefill shard
SHAPES = ((2, 1024, 3072, "bfloat16"), (128, 1024, 3072, "bfloat16"),
          (256, 1024, 3072, "bfloat16"), (2, 64, 3072, "bfloat16"),
          (128, 64, 3072, "bfloat16"), (1024, 1024, 3072, "bfloat16"),
          (1024, 2048, 8192, "bfloat16"), (1024, 2048, 11008, "bfloat16"),
          (1024, 5120, 8192, "bfloat16"), (1024, 7168, 20480, "bfloat16"),
          (512, 1024, 1536, "bfloat16"), (2, 1024, 3072, "float32"),
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
# the crossover sweep: bf16 at qwen3-0.6b's width, M = BF16_SWEEP_ROWS
BF16_SWEEP_ROWS = (128, 256, 384, 512, 1024)
BF16_SWEEP_KN = (1024, 3072)
# both bf16 kernels at the other train shapes of PERF.md's table (M, K, N):
# TRAIN_GLU_TIMED's four in chip_smoke.py and a sharded qwen3 rank's
BF16_TRAIN = ((1024, 2048, 8192), (1024, 2048, 11008), (1024, 5120, 8192),
              (1024, 7168, 20480), (512, 1024, 1536))
CROSSOVER_RANGE = (128, 512)   # the crossover is kept within (lo, hi]
# the K sweep: both bf16 kernels at the train step's M and each N of
# BF16_K_SWEEP_N, K = BF16_K_SWEEP_K (qwen3 1024, olmo 2048, llama4 5120,
# yi-34b 7168 and the K between)
BF16_K_SWEEP_M = 1024
BF16_K_SWEEP_N = (3072, 8192, 11008)
BF16_K_SWEEP_K = (1024, 2048, 3072, 4096, 5120, 7168)
# tma_wgmma_gemm at split 1 and at split 2 on the shapes where its
# geometry picks split 2 on the main path (a sharded qwen3 rank)
BF16_SPLIT_SHAPES = ((512, 1024, 1536),)
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


def gemm_phases_of(stamps: np.ndarray) -> dict:
    """Phase durations (ns) of one tma_wgmma_gemm launch from its [ctas,
    GEMM_SLOTS] stamps: by the tile's place in its CTA's walk, the means
    over the CTAs that ran it of its first stage's wait (from the CTA's
    start for the first two tiles, the two warpgroups' first; from the
    end of the tile two places before, the same warpgroup's, after), its
    K loop and its epilogue; the span from the first start to the last
    end."""
    a = stamps[stamps[:, 0] > 0].astype(np.int64)
    t0 = a[:, 0].min()
    tiles = []
    for i in range(GEMM_TILES):
        landed, kdone, stored = (a[:, 3 + 3 * i + j] for j in range(3))
        ran = stored > 0
        if not ran.any():
            break
        since = a[ran, 0] if i < 2 else a[ran, 3 + 3 * (i - 2) + 2]
        tiles.append({"tile": i, "ctas": int(ran.sum()),
                      "wait_first_stage": float(np.mean(landed[ran] - since)),
                      "k_loop": float(np.mean(kdone[ran] - landed[ran])),
                      "epilogue": float(np.mean(stored[ran] - kdone[ran]))})
    return {"ctas": int(len(a)), "span": float(a[:, 2].max() - t0),
            "start_spread": float(a[:, 0].max() - t0),
            "to_last_issue": float(np.mean(a[:, 1] - a[:, 0])),
            "tiles": tiles}


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


def tma_variant(m: int, k: int, n: int, dtype: str) -> tuple[str, int]:
    """The TMA variant the wrapper picks for these operands, and its
    split (0 where it takes none)."""
    if dtype == "float32":
        return "tma_f32", epi._glu_f32_geometry(m, n, k)[-1]
    variant = epi._glu_variant(m, n, k, torch.bfloat16, True)
    split = epi._glu_bf16_geometry(m, n, k)[-1] \
        if variant == "tma_wgmma_gemm" else 0
    return variant, split


def _median(runs):
    """The median of each number over the runs' dicts (lists of dicts by
    place, as ``gemm_phases_of`` gives, likewise over the runs that have
    that place)."""
    out = {}
    for key, v in runs[0].items():
        if isinstance(v, list):
            out[key] = [_median([r[key][i] for r in runs if len(r[key]) > i])
                        for i in range(max(len(r[key]) for r in runs))]
        else:
            out[key] = statistics.median(r[key] for r in runs)
    return out


def measure(lib, m: int, k: int, n: int, dtype: str = "bfloat16",
            launches: int = 8, split: int | None = None) -> dict:
    """The phases of ``launches`` launches of the TMA variant the wrapper
    picks for ``dtype`` and M (at ``split``, by default the wrapper's)."""
    ops = operands(m, k, n, dtype)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    variant, own_split = tma_variant(m, k, n, dtype)
    split = own_split if split is None else split
    gemm = variant == "tma_wgmma_gemm"
    buf = (ctypes.c_ulonglong * (MAX_CTAS * 8))()
    if lib.repro_glu_phases(buf, MAX_CTAS) != 0:   # clears earlier stamps
        raise RuntimeError("clearing the phase stamps failed")
    runs = []
    for _ in range(launches):
        timed(lib, ops, variant, split, flush)
        rc = lib.repro_glu_phases(buf, MAX_CTAS)
        if rc != 0:
            raise RuntimeError(f"reading the phase stamps failed: {rc}")
        stamps = np.frombuffer(buf, dtype=np.uint64)
        runs.append(gemm_phases_of(stamps.reshape(-1, GEMM_SLOTS)) if gemm
                    else phases_of(stamps.reshape(MAX_CTAS, 8)))
    return {"variant": variant, "split": split, **_median(runs)}


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


def bf16_sweep(lib, shapes=None) -> list[dict]:
    """Both bf16 TMA kernels' event times at ``shapes`` (M, K, N; by
    default BF16_SWEEP_KN at every BF16_SWEEP_ROWS row count), on the same
    inputs (tma_wgmma_gemm at the split its geometry picks)."""
    if shapes is None:
        shapes = [(m, *BF16_SWEEP_KN) for m in BF16_SWEEP_ROWS]
    out = []
    for m, k, n in shapes:
        ops = operands(m, k, n, "bfloat16")
        split = epi._glu_bf16_geometry(m, n, k)[-1]
        out.append({"shape": [m, k, n], "gemm_split": split, "events_ms": {
            "tma_wgmma": event_ms(lib, ops, "tma_wgmma", 0),
            "tma_wgmma_gemm": event_ms(lib, ops, "tma_wgmma_gemm", split)}})
    return out


def crossover(sweep: list[dict], capped: bool = True) -> int | None:
    """GLU_GEMM_ROWS as the sweep measures it: the lowest swept M from
    which tma_wgmma_gemm is faster than tma_wgmma at every swept M (None
    if at no swept M); ``capped``, kept to the swept M within
    CROSSOVER_RANGE (lo, hi] (the top for None)."""
    first = None
    for line in reversed(sweep):
        ms = line["events_ms"]
        if ms["tma_wgmma_gemm"] >= ms["tma_wgmma"]:
            break
        first = line["shape"][0]
    if not capped:
        return first
    lo, hi = CROSSOVER_RANGE
    lowest = min(line["shape"][0] for line in sweep if line["shape"][0] > lo)
    return hi if first is None else min(max(first, lowest), hi)


def gemm_faster_to_k(sweep: list[dict]) -> int | None:
    """What a K sweep at one M and N says of GLU_GEMM_MAX_K: the largest
    swept K up to which tma_wgmma_gemm is faster than tma_wgmma at every
    swept K (None if not at the first)."""
    last = None
    for line in sweep:
        ms = line["events_ms"]
        if ms["tma_wgmma_gemm"] >= ms["tma_wgmma"]:
            break
        last = line["shape"][1]
    return last


def split_events(lib, m: int, k: int, n: int, launches: int = 30) -> dict:
    """Event times of tma_wgmma_gemm at split 1 and at split 2, and of
    tma_wgmma, on the same inputs; each read twice, in the order 1, 2, 2,
    1 (tma_wgmma between), the median of each."""
    ops = operands(m, k, n, "bfloat16")
    runs = {"split_1": [], "split_2": [], "tma_wgmma": []}
    for split in (1, 2, 2, 1):
        runs[f"split_{split}"].append(
            event_ms(lib, ops, "tma_wgmma_gemm", split, launches))
        if len(runs["tma_wgmma"]) < 2:
            runs["tma_wgmma"].append(
                event_ms(lib, ops, "tma_wgmma", 0, launches))
    return {"shape": [m, k, n],
            "geometry_split": epi._glu_bf16_geometry(m, n, k)[-1],
            "events_ms": {key: statistics.median(v)
                          for key, v in runs.items()}, "reads_ms": runs}


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
    sweep = bf16_sweep(lib)
    for line in sweep:
        print(json.dumps({"phase": "glu_bf16_sweep", "card": card, **line}),
              flush=True)
    print(json.dumps({"phase": "glu_bf16_crossover", "card": card,
                      "measured_glu_gemm_rows": crossover(sweep),
                      "measured_uncapped": crossover(sweep, capped=False),
                      "glu_gemm_rows": epi.GLU_GEMM_ROWS}), flush=True)
    for line in bf16_sweep(lib, BF16_TRAIN):
        print(json.dumps({"phase": "glu_bf16_train", "card": card, **line}),
              flush=True)
    for n in BF16_K_SWEEP_N:
        sweep = bf16_sweep(lib, [(BF16_K_SWEEP_M, k, n)
                                 for k in BF16_K_SWEEP_K])
        for line in sweep:
            print(json.dumps({"phase": "glu_bf16_k_sweep", "card": card,
                              **line}), flush=True)
        print(json.dumps({"phase": "glu_bf16_k_crossover", "card": card,
                          "m": BF16_K_SWEEP_M, "n": n,
                          "gemm_faster_to_k": gemm_faster_to_k(sweep),
                          "glu_gemm_max_k": epi.GLU_GEMM_MAX_K}),
              flush=True)
    for m, k, n in BF16_SPLIT_SHAPES:
        print(json.dumps({"phase": "glu_bf16_split", "card": card,
                          **split_events(lib, m, k, n)}), flush=True)
    for m, k, n in F32_TABLE:
        print(json.dumps({"phase": "glu_f32_sweep", "card": card,
                          "shape": [m, k, n], **f32_sweep(lib, m, k, n)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
