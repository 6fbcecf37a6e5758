"""A frozen copy of the Catmull-Rom tanh unit the benchmark's reference
runs, written from the paper (Eq. 2/3) and kept apart from the program.

A uniform knot table of tanh on [0, x_max) with ``depth`` segments: knot
k (k = -1 .. depth + 2) holds tanh(k * period), segment k reads the four
knots k-1 .. k+2. An input's magnitude is split into a segment index and
a local t in [0, 1), the four Catmull-Rom basis weights (the 1/2
included) multiply the four knots, |x| >= x_max saturates to
tanh(x_max), and the sign is restored (tanh is odd). SiLU comes from the
same unit: silu(x) = x * (1 + tanh(x / 2)) / 2. All arithmetic is f32.
"""
from __future__ import annotations

import numpy as np
import torch


def tanh_windows(x_max: float = 4.0, depth: int = 32) -> np.ndarray:
    """[depth, 4] f32 knot windows: row k = tanh at knots k-1 .. k+2."""
    period = x_max / depth
    knots = np.tanh(np.arange(-1, depth + 3, dtype=np.float64) * period)
    idx = np.arange(depth)[:, None] + np.arange(4)[None, :]
    return knots[idx].astype(np.float32)


def tanh(v: torch.Tensor, windows: torch.Tensor, x_max: float = 4.0):
    """Catmull-Rom tanh of an f32 tensor ``v`` through ``windows``."""
    depth = windows.shape[0]
    av = v.abs()
    u = av * (depth / x_max)
    k = torch.clamp(torch.floor(u), 0.0, depth - 1.0)
    t = u - k
    p = windows[torch.nan_to_num(k).long()]                 # [..., 4]
    w0 = 0.5 * (((-t + 2.0) * t - 1.0) * t)
    w1 = 0.5 * ((3.0 * t - 5.0) * t * t + 2.0)
    w2 = 0.5 * (((-3.0 * t + 4.0) * t + 1.0) * t)
    w3 = 0.5 * ((t - 1.0) * t * t)
    y = p[..., 0] * w0 + p[..., 1] * w1 + p[..., 2] * w2 + p[..., 3] * w3
    y = torch.where(av >= x_max, float(np.float32(np.tanh(x_max))), y)
    return torch.where(v < 0.0, -y, y)


def silu(v: torch.Tensor, windows: torch.Tensor, x_max: float = 4.0):
    return v * (0.5 * (1.0 + tanh(v * 0.5, windows, x_max)))
