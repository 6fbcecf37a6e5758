"""mfu.chat: The window's model FLOPs (2 N D over the tokens prefilled and emitted) over the engine's step time in it at the bf16 peak, in percent."""
from benchlib import readers


def read(rec):
    return readers.mfu(rec, "engine_s")
