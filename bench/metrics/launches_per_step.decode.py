"""launches_per_step.decode: Kernels launched by the decode chunks a decode step in the traced slice."""
from benchlib import readers


def read(rec):
    return readers.launches_per_step(rec, "bench.decode")
