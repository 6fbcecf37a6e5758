"""glu_2d_roofline.decode: The summed bound over the summed device time of the glu_2d launches of the traced decode chunks, in percent."""
from benchlib import readers


def read(rec):
    return readers.kernel_roofline(rec, "glu_2d", "bench.decode")
