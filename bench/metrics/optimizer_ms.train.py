"""optimizer_ms.train: Device time of the program's train.optimizer spans (clip, AdamW, the frozen-leaf restore, the non-finite select) a train step of the traced slice, in ms, in stream order by CUDA events."""
from benchlib import spans


def read(rec):
    return spans.train_phase_ms("train.optimizer")
