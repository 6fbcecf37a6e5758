"""device_idle_share.train: The share of the traced slice's wall in which no device operation ran, in percent."""
from benchlib import readers


def read(rec):
    return readers.idle_share(rec)
