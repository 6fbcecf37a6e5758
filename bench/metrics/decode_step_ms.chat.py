"""decode_step_ms.chat: EngineStats.decode_s / decode_steps over the window, in ms."""


def read(rec):
    return _decode_step_ms(rec)


def _decode_step_ms(rec):
    w = rec.window
    return 1e3 * w["decode_s"] / w["decode_steps"] if w.get("decode_steps") else None
