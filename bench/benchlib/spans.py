"""What the readers of the program's own spans (``repro_torch.spans``)
share: the device's idle time inside the program's ``repro.*`` host
ranges of the traced slice, and the spans' device times in stream order
(``repro_torch.spans.device_ms``). Each reads None where the program has
no such span (a checkout from before them): the trace then holds no
``repro.*`` range, and the package no ``spans`` module."""
from __future__ import annotations

import torch

from . import readers


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs, ys) -> float:
    """The length of the intersection of two sorted disjoint lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(sl, name: str):
    """Seconds of the slice's wall inside the host ranges named ``name``
    in which no device operation ran; None when the slice has none."""
    ranges = [(a, b) for a, b, n in sl.host if n == name]
    if not ranges:
        return None
    inside = merged(ranges, sl.start, sl.end)
    busy = merged(((o[1], o[1] + o[2]) for o in sl.ops), sl.start, sl.end)
    length = sum(b - a for a, b in inside)
    return (length - overlap(inside, busy)) / 1e6


def idle_share_inside(rec, name: str):
    """100 x the device's idle time inside the host ranges ``name`` over
    the slice's wall; None for an unsound slice or one without them."""
    sl = readers._slice(rec)
    if sl is None or sl.window_s <= 0:
        return None
    idle = idle_inside(sl, name)
    return None if idle is None else 100.0 * idle / sl.window_s


def device_ms():
    """The program's {span or parent/span: (count, summed ms)}, after a
    device sync; None where the program has no spans."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return spans.device_ms()


def train_phase_ms(name: str):
    """Device ms a train step of the span ``name`` (all of its spans'
    time over the ``train.step`` spans)."""
    d = device_ms()
    if not d or name not in d or not d.get("train.step", (0,))[0]:
        return None
    return d[name][1] / d["train.step"][0]
