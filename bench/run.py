#!/usr/bin/env python3
"""The benchmark of ``repro_torch`` on one H100: runs one cell of
``BENCHMARK.json`` and prints its result as the last line of standard
output.

    python3 bench/run.py --workload olmo-1b.train --seed 7 --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a traced slice after the window). Every run checks
what the timed path produced against the plain reference in
``bench/benchref`` and prints each number compared beside its limit, as
the last lines of standard error and under ``checks`` in the result.
Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; with any JAX module or the JAX package loaded after
the window, it exits 3.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunRecord:
    """What one run measured and read."""

    def __init__(self, t_process: float):
        self.t_process = t_process
        self.setup_s = None
        self.window: dict = {}
        self.metrics: dict = {}
        self.slice = None
        self.readings = None
        self.reference = None
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0
        self.notes: list[str] = []
        self.sample = None


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell, args, device, program=None, t_process=None) -> RunRecord:
    """The run of ``cell`` on ``device`` (the tests drive it on the CPU);
    ``program`` plants a fault in the program for the tests."""
    from benchlib import serve_cell, train_cell
    rec = RunRecord(T_PROCESS if t_process is None else t_process)
    mod = {"train": train_cell, "serve": serve_cell}[cell.kind]
    mod.run(cell, args, rec, device, say, program=program)
    return rec


def checks(cell, rec) -> dict:
    """{name: (value, limit)} of every number compared."""
    lim = cell.settings["limits"]
    if cell.kind == "train":
        from benchlib.train_cell import compare
        got = compare(rec.readings, rec.reference)
        if got["leaves_left_out"]:
            say(f"leaves left out of the check: {got['leaves_left_out']}")
        for k in ("loss_gap", "grad_gap", "change_gap"):
            if k not in lim:
                say(f"not compared: {k} {got[k]!r}")
        nums = got
    else:
        nums = rec.readings
    out = {k: (nums[k], v) for k, v in lim.items()}
    out["failed"] = (rec.failed, 0)
    return out


def _reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def result(cell, rec, args, device_info: dict) -> dict:
    metrics = {}
    if args.trace:
        for m in cell.per_layer():
            v = _reader(m["name"])(rec)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(rec.metrics, setup_s=rec.setup_s)
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    chk = checks(cell, rec)
    correct = rec.attempted > 0 and all(
        math.isfinite(v) and v <= lim for v, lim in chk.values())
    out = {"correct": bool(correct), "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device_info}
    if args.trace and rec.slice is not None:
        sl = rec.slice
        out["device"] = dict(device_info, busy_s=sl.busy_s, window_s=sl.window_s)
        out["breakdown"] = {"device_ops": sl.device_ops(),
                            "idle_gaps": sl.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in chk.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from benchlib import spec
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = run_cell(cell, args, device)
    if torch.cuda.is_available():
        rec.peak_bytes = max(rec.peak_bytes,
                             rec.window.get("peak_bytes", 0))
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips, "memory_peak_bytes": int(rec.peak_bytes)}
    out = result(cell, rec, args, info)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        say(f"modules loaded that no run may load: {loaded}")
        return 3
    for note in rec.notes:
        say(f"reading failed: {note}")
    say(f"sample (prompt, served) of the check: {rec.sample}" if rec.sample
        else f"readings {rec.readings}; reference {rec.reference}")
    for k, c in out["checks"].items():
        say(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
