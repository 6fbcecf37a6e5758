"""queue_wait_p95_ms.chat: The 95th percentile over the requests due in the window of due time to admission, in ms."""


def read(rec):
    return 1e3 * rec.window["queue_wait_p95_s"]
