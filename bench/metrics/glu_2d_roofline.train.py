"""glu_2d_roofline.train: The summed bound over the summed device time of the glu_2d launches of the traced train steps, in percent."""
from benchlib import readers


def read(rec):
    return readers.kernel_roofline(rec, "glu_2d")
