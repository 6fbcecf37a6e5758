"""launches_per_step.train: Kernels launched a train step in the traced slice."""
from benchlib import readers


def read(rec):
    return readers.launches_per_step(rec, "bench.train_step")
