"""mfu.decode: The window's model FLOPs (2 N D over the tokens prefilled and emitted) over its wall time at the bf16 peak, in percent."""
from benchlib import readers


def read(rec):
    return readers.mfu(rec, "wall_s")
