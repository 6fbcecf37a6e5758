"""elementwise_2d_roofline.chat: The summed bound over the summed device time of the elementwise_2d launches (the experts' SiLU) of the traced decode chunks, in percent."""
from benchlib import readers


def read(rec):
    return readers.kernel_roofline(rec, "elementwise_2d", "bench.decode")
