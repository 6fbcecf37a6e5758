"""backward_ms.train: Device time of the program's train.backward spans (the gradients, the blocks' recompute included) a train step of the traced slice, in ms, in stream order by CUDA events."""
from benchlib import spans


def read(rec):
    return spans.train_phase_ms("train.backward")
