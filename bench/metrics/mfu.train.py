"""mfu.train: The window's model FLOPs (6 N D) over its wall time at the bf16 peak, in percent."""
from benchlib import readers


def read(rec):
    return readers.mfu(rec, "wall_s")
