"""attention_share.decode: Device time of the program's model.attention spans opened inside its serve.decode spans over the device time of those serve.decode spans, in percent, both in stream order by CUDA events."""
from benchlib import spans


def read(rec):
    d = spans.device_ms()
    if not d or "serve.decode/model.attention" not in d or \
            not d.get("serve.decode", (0, 0.0))[1]:
        return None
    return 100.0 * d["serve.decode/model.attention"][1] / d["serve.decode"][1]
