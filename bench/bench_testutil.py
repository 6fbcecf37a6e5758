"""Helpers of the benchmark's CPU tests: a cell of ``BENCHMARK.json`` cut to
the program's smoke sizes and short traffic, run on the CPU through the
harness's own code below its look for a chip."""
from __future__ import annotations

import copy
import time
import types

import torch

from benchlib import spec

# limits for the smoke sizes' bf16-on-CPU runs, set from what sound runs
# and the fp8 control read there: training, loss 3e-4, gradient 1.2e-3,
# change 4e-4; olmo's widest served gap at most 0.015, its control's at
# least 0.14; mixtral's mean served gap 0.006-0.018, its control's
# 0.074-0.130 (its widest gap, 0.12-0.54 against 0.51-1.37, does not
# separate: the smoke model's routing flips on near-ties). The cells' own
# limits are set from chip runs at full size.
SMOKE_LIMITS = {"loss_gap": 5e-3, "grad_gap": 2e-2, "change_gap": 5e-3,
                "served_gap": 0.1, "served_gap_mean": 0.05}


def smoke_cell(workload: str) -> spec.Cell:
    cell = spec.load(workload)
    cfg = copy.deepcopy(cell.config)
    prog = dict(cfg["program"], smoke=True)
    from repro_torch.configs import common, registry
    c = common.fused_of(registry.get(prog["registry"], smoke=True,
                                     **prog.get("overrides", {})))
    model = {k: getattr(c, k) for k in cfg["model"] if k != "activation"}
    model["activation"] = cfg["model"]["activation"]
    cell.config = dict(cfg, program=prog, model=model,
                       eos_token_id=model["vocab_size"] - 1)
    st = copy.deepcopy(cell.settings)
    st["limits"] = {k: SMOKE_LIMITS[k] for k in st["limits"]}
    if cell.kind == "train":
        st["train"] = dict(st["train"], batch=2, seq=32, ring=4)
    else:
        st["engine"] = dict(st["engine"], slots=4, max_prompt_len=64,
                            max_len=96)
        st.update(warmup_s=0.5, drain_s=8, stall_s=3, ramp_s=0.1,
                  requests_per_client=400, rate_per_s=4.0)
        st["check"] = dict(st["check"], tokens=60, max_requests=3)
        t = dict(cell.traffic,
                 prompt_len={"dist": "uniform", "min": 8, "max": 64},
                 output_len={"dist": "uniform", "min": 4, "max": 16})
        if t["loop"] == "closed":
            t["clients"] = 4
        cell.traffic = t
    cell.settings = st
    return cell


def run_smoke(cell, seed: int = 2**31 + 17, seconds: float = 1.0,
              program=None, precisions=("f32",)):
    """(record, result) of one CPU run of ``cell``."""
    import run as bench_run
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0,
                                     precisions=precisions)
        rec = bench_run.run_cell(cell, args, torch.device("cpu"),
                                 program=program, t_process=time.perf_counter())
        return rec, bench_run.result(cell, rec, args, {"platform": "cpu"})
    finally:
        torch.set_num_threads(n)
