"""batch_occupancy.decode: EngineStats.decode_utilization(slots) over the window, in percent."""


def read(rec):
    return 100.0 * rec.window["decode_utilization"]
