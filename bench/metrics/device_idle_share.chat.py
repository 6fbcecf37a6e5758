"""device_idle_share.chat: The share of the traced slice's wall in which no device operation ran, in percent."""
from benchlib import readers


def read(rec):
    return readers.idle_share(rec)
