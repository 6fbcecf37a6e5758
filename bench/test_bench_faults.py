"""A run's ``correct`` catches a broken timed path: each cell driven on the
CPU below its look for a chip, at the smoke sizes, comes out correct as
it is and not correct with a fault planted in the program underneath.
The control (the reference in fp8 in the program's place) fails the same
limits."""
import math

import pytest
import torch

from bench_testutil import SMOKE_LIMITS, run_smoke, smoke_cell
from benchlib import faults, spec, train_cell


@pytest.mark.parametrize("fault", [None, faults.state_unchanged, faults.half_batch],
                         ids=["sound", "state_unchanged", "half_batch"])
def test_train_cell_fault_fails(fault):
    _, res = run_smoke(smoke_cell("olmo-1b.train"), seconds=0.5, program=fault)
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("workload", ["mixtral-8x22b-pp8.chat",
                                      "olmo-1b.longctx"])
@pytest.mark.parametrize("fault", [None, faults.token_altered,
                                   faults.half_rows_dropped],
                         ids=["sound", "token_altered", "half_rows_dropped"])
def test_serve_cell_fault_fails(workload, fault):
    cell = smoke_cell(workload)
    rec, res = run_smoke(cell, seconds=1.0, program=fault)
    assert rec.attempted > 0
    assert res["correct"] is (fault is None), res["checks"]


def test_train_control_fails():
    cell = smoke_cell("olmo-1b.train")
    cfg = spec.program_config(cell.config)
    dev = torch.device("cpu")
    seed = 2**31 + 17
    ref = train_cell.reference_readings(cell, cfg, seed, dev, "f32")
    low = train_cell.reference_readings(cell, cfg, seed, dev, "fp8")
    got = train_cell.compare(low, ref)
    assert any(got[k] > SMOKE_LIMITS[k]
               for k in ("loss_gap", "grad_gap", "change_gap")), got


@pytest.mark.parametrize("workload", ["mixtral-8x22b-pp8.chat",
                                      "olmo-1b.longctx"])
@pytest.mark.parametrize("seed", [1000, 1001, 1002])
def test_serve_control_fails(workload, seed):
    cell = smoke_cell(workload)
    rec, res = run_smoke(cell, seed=seed, seconds=1.0,
                         precisions=("f32", "fp8"))
    assert res["correct"], res["checks"]
    for k, lim in cell.settings["limits"].items():
        low = rec.readings[k.replace("served_gap", "fp8_top_gap")]
        assert math.isfinite(low) and low > lim, (k, rec.readings)
