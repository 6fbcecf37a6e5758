"""What the per-layer metrics' readers (``metrics/<name>.py``) share. A
reader takes the run's record and returns a number, or None where it
finds nothing to read or the reading failed (a trace the guard found
unsound, a launch missing its kernel, a share of a roofline past 100%);
a failed reading is noted on standard error, never reported as a number."""
from __future__ import annotations

from . import roofline


def _slice(rec):
    sl = rec.slice
    if sl is None:
        return None
    if not sl.ok:
        rec.notes.append(f"trace unsound: {sl.why}")
        return None
    return sl


def kernel_roofline(rec, kernel: str, host_range: str | None = None):
    """100 x the summed bound over the summed device time of ``kernel``'s
    launches in the traced slice (only those launched in ``host_range``
    when given)."""
    sl = _slice(rec)
    if sl is None:
        return None
    pairs = sl.kernel_pairs(kernel)
    if pairs is None:
        rec.notes.append(f"{kernel}: host launches and device kernels differ "
                         f"in number in the trace ({sl.counts(kernel)})")
        return None
    pairs = [(h, t) for h, t in pairs if host_range in (None, h[1])]
    if not pairs:
        return None
    bound = 0.0
    for (name, _, f), _ in pairs:
        if name == "glu_2d":
            tf, vf, nb = roofline.glu_work(f["m"], f["k"], f["n"], f["itemsize"],
                                           f["act"], f["params"])
            peak = roofline.PEAK_FLOPS_BF16 if f["itemsize"] == 2 \
                else roofline.PEAK_FLOPS_F32
        else:
            tf, vf, nb = roofline.elementwise_work(f["n"], f["itemsize"],
                                                   f["act"], f["params"])
            peak = roofline.PEAK_FLOPS_BF16
        bound += roofline.bound_s(tf, vf, nb, peak)
    share = 100.0 * bound / sum(t for _, t in pairs)
    if share > 100.0:
        rec.notes.append(f"{kernel}: roofline share {share!r}% > 100%")
        return None
    return share


def mfu(rec, time_key: str = "wall_s"):
    """100 x the window's model FLOPs over its time at the bf16 peak."""
    w = rec.window
    t = w.get(time_key) or 0.0
    return 100.0 * w["model_flops"] / (t * roofline.PEAK_FLOPS_BF16) if t else None


def launches_per_step(rec, host_range: str):
    """Kernels launched in ``host_range`` a step of it, in the slice."""
    sl = _slice(rec)
    if sl is None or not sl.steps.get(host_range):
        return None
    n = sum(1 for k in sl.kernels if k[3] == host_range)
    return n / sl.steps[host_range]


def idle_share(rec):
    """100 x the share of the slice's wall in which no device operation
    ran."""
    sl = _slice(rec)
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
