"""Where the time of one ``glu_2d`` TMA launch goes, phase by phase.

    PYTHONPATH=src python -m repro_torch.kernels.glu_phases

Needs the card. Builds the kernel library with ``-DREPRO_GLU_PHASES``
(a separate library: the served one has no stamps), launches the
``tma_wgmma`` variant at the served FFN's shapes with the L2 cache
overwritten before each launch, and reads the %globaltimer stamps that
thread 0 of every CTA wrote (ns). Prints one JSON line per shape: the
median over launches of the mean over CTAs of each phase, and of the
launch's span from its first CTA's start to its last CTA's end.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi

PHASE_FLAG = ("-DREPRO_GLU_PHASES",)
# the stamp slots of csrc/epilogue.cu (GLU_PHASE): 0 CTA start, 1 the
# producer's last TMA issue, 2 the first stage landed, 3 the K loop done,
# 4 the partials parked, 5 past the first cluster barrier, 6 the epilogue
# stored, 7 past the second cluster barrier.
# (phase, from slot, to slot), each a mean over CTAs
PHASES = (("to_last_issue", 0, 1), ("to_first_stage", 0, 2),
          ("k_loop", 0, 3), ("park_partials", 3, 4),
          ("cluster_barrier_1", 4, 5), ("reduce_epilogue_store", 5, 6),
          ("cluster_barrier_2", 6, 7))
SHAPES = ((2, 1024, 3072), (128, 1024, 3072), (256, 1024, 3072),
          (2, 64, 3072), (128, 64, 3072))
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


def measure(lib, m: int, k: int, n: int, launches: int = 8) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    wg = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    wu = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    table = epi.table_for("silu", 4.0, 32)
    spec = epi.TableSpec.of(table)
    p = torch.as_tensor(table.windows, dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    args = epi._kernel_args("silu", spec, p, x)
    variant = epi._GLU_VARIANT_IDS["tma_wgmma"]
    buf = (ctypes.c_ulonglong * (MAX_CTAS * 8))()
    runs = []
    for _ in range(launches):
        flush.zero_()
        torch.cuda.synchronize()
        rc = lib.repro_glu_2d(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                              p.data_ptr(), out.data_ptr(), m, n, k, *args,
                              variant, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"glu_2d launch failed: cudaError {rc}")
        rc = lib.repro_glu_phases(buf, MAX_CTAS)
        if rc != 0:
            raise RuntimeError(f"reading the phase stamps failed: {rc}")
        runs.append(phases_of(np.frombuffer(buf, dtype=np.uint64)
                              .reshape(MAX_CTAS, 8)))
    return {key: statistics.median(r[key] for r in runs) for key in runs[0]}


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
    lib = load()
    card = card_line()
    for m, k, n in SHAPES:
        print(json.dumps({"phase": "glu_phases", "card": card,
                          "shape": [m, k, n], "unit": "ns",
                          **measure(lib, m, k, n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
