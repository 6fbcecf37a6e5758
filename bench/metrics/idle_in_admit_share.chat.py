"""idle_in_admit_share.chat: The device's idle time inside the program's repro.serve.admit host ranges (scheduling, page reservation, prefill and insert) over the traced slice's wall, in percent."""
from benchlib import spans


def read(rec):
    return spans.idle_share_inside(rec, "repro.serve.admit")
