"""idle_in_decode_share.decode: The device's idle time inside the program's repro.serve.decode host ranges (a decode chunk through its token pull) over the traced slice's wall, in percent."""
from benchlib import spans


def read(rec):
    return spans.idle_share_inside(rec, "repro.serve.decode")
