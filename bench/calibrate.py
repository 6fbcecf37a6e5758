#!/usr/bin/env python3
"""Readings behind the benchmark's fixed numbers, on the chip; the
benchmark's own runs never run this.

    # the knee of an open-loop cell: one engine, rates in turn (warm-up,
    # window, drain at each)
    python3 bench/calibrate.py --workload mixtral-8x22b-pp8.chat --sweep 4,8,12 --seconds 20

    # the numbers compared, over seeds, in one process; with --control
    # also the control's: the reference in fp8 in the program's place;
    # with --fault, of the program with that fault planted
    python3 bench/calibrate.py --workload olmo-1b.train --seeds 1,2,3 --seconds 5 --control
    python3 bench/calibrate.py --workload olmo-1b.train --seeds 1,2,3 --seconds 5 --fault half_batch

Each result is one JSON line on standard output.
"""
import json
import math
import sys
import time
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import argparse  # noqa: E402

import run as bench_run  # noqa: E402


def sweep(cell, rates, seconds, warm, device, seed):
    import torch
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    from benchlib import serve_cell, spec, weights
    cfg = spec.program_config(cell.config)
    w = weights.make(cfg, cell.model, seed, "serve", device)
    eng = ServeEngine(cfg, w, EngineConfig(**cell.settings["engine"]),
                      device=device)
    for i, rate in enumerate(rates):
        cell.settings["rate_per_s"] = rate
        loop = serve_cell.Loop(eng, cell, seed + i, warm + seconds + 120,
                               uid0=(i + 1) * 10**6)
        loop.t_start = time.perf_counter()
        while time.perf_counter() - loop.t_start < warm:
            loop.step()
        tw0 = time.perf_counter()
        tok0, st0 = loop.host_tokens(), eng.snapshot()
        while (t1 := loop.step()) - tw0 < seconds:
            pass
        tok1, st1 = loop.host_tokens(), eng.snapshot()
        due = [u for u, d in loop.due.items() if tw0 <= d < t1]
        ttft = [(loop.first[u] - loop.due[u]) if u in loop.first else math.inf
                for u in due]
        fin = [c for c in loop.done.values() if tw0 < c.finished_at <= t1]
        tpot = [(c.finished_at - loop.first[c.uid]) / (len(c.tokens) - 1)
                for c in fin if len(c.tokens) > 1]
        st = st1.delta(st0)
        print(json.dumps({
            "rate_per_s": rate, "due": len(due), "finished": len(fin),
            "tokens_per_s": (tok1 - tok0) / (t1 - tw0),
            "ttft_p50_ms": 1e3 * sorted(ttft)[len(ttft) // 2] if ttft else None,
            "ttft_p95_ms": 1e3 * serve_cell.p95(ttft),
            "tpot_p95_ms": 1e3 * serve_cell.p95(tpot),
            "queue_end": st1.queue_depth, "queue_start": st0.queue_depth,
            "decode_step_ms": 1e3 * st.decode_s / max(st.decode_steps, 1),
            "occupancy": st.decode_utilization(cell.settings["engine"]["slots"]),
            "engine_busy_share": loop.engine_s / (time.perf_counter() - loop.t_start),
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}),
            flush=True)
        loop.submitting = False
        t_d = time.perf_counter()
        while eng.sched.pending and time.perf_counter() - t_d < 120:
            loop.step()


def seeds(cell, seed_list, seconds, control, device, fault=""):
    from benchlib import faults, spec, train_cell
    program = (faults.TRAIN if cell.kind == "train" else faults.SERVE)[fault] \
        if fault else None
    for seed in seed_list:
        args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0)
        if control and cell.kind == "serve":
            args.precisions = ("f32", "fp8")
        rec = bench_run.run_cell(cell, args, device, program=program,
                                 t_process=time.perf_counter())
        out = {"seed": seed, "fault": fault, "readings": rec.readings,
               "attempted": rec.attempted,
               "failed": rec.failed,
               "metrics": rec.metrics, "sample": rec.sample,
               "checks": {k: v[0] for k, v in bench_run.checks(cell, rec).items()}}
        if control:
            if cell.kind == "train":
                cfg = spec.program_config(cell.config)
                low = train_cell.reference_readings(cell, cfg, seed, device, "fp8")
                out["control"] = {k: v for k, v in train_cell.compare(
                    low, rec.reference).items() if k != "leaves_left_out"}
                out["control_losses"] = low["losses"]
            else:
                out["control"] = {"served_gap": rec.readings["fp8_top_gap"],
                                  "served_gap_mean": rec.readings["fp8_top_gap_mean"]}
        print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--sweep", default="")
    ap.add_argument("--warmup", type=float, default=15)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="", help="a fault of benchlib/faults.py")
    a = ap.parse_args()
    import torch

    from benchlib import spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load(a.workload)
    if a.sweep:
        sweep(cell, [float(r) for r in a.sweep.split(",")], a.seconds,
              a.warmup, device, 1234567)
    if a.seeds:
        seeds(cell, [int(s) for s in a.seeds.split(",")], a.seconds,
              a.control, device, a.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
