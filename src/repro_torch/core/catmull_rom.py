"""Cubic Catmull-Rom spline interpolation (paper Eq. 2/3), float half.

Counterpart of ``repro/core/catmull_rom.py``: the basis, host-side knot
table construction (numpy, identical to the reference) and the float
interpolators on tensors. The bit-accurate fixed-point datapath
(``build_fixed_table``, ``interpolate_fixed``) arrives with the
fixed-point slice (ROADMAP.md, Queue A item 2).

``interpolate`` keeps the reference's numerics: it divides by the period
and casts the knot windows to the input's dtype, so a bf16 input is
interpolated in bf16 arithmetic, exactly as the reference's jnp path is.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# Rows act on [P_{k-1}, P_k, P_{k+1}, P_{k+2}]; columns are t^3, t^2, t, 1.
# f(t) = 0.5 * P . (BASIS @ [t^3, t^2, t, 1])
BASIS = np.array(
    [
        [-1.0, 2.0, -1.0, 0.0],
        [3.0, -5.0, 0.0, 2.0],
        [-3.0, 4.0, 1.0, 0.0],
        [1.0, -1.0, 0.0, 0.0],
    ]
)


def basis_weights(t):
    """The four CR basis polynomial values at t (float), incl. the 1/2.

    Uses Horner form; returns shape t.shape + (4,)."""
    t = torch.as_tensor(t)
    w0 = 0.5 * (((-t + 2.0) * t - 1.0) * t)          # -t^3 + 2t^2 - t
    w1 = 0.5 * ((3.0 * t - 5.0) * t * t + 2.0)       # 3t^3 - 5t^2 + 2
    w2 = 0.5 * (((-3.0 * t + 4.0) * t + 1.0) * t)    # -3t^3 + 4t^2 + t
    w3 = 0.5 * ((t - 1.0) * t * t)                   # t^3 - t^2
    return torch.stack([w0, w1, w2, w3], dim=-1)


class SplineTable(NamedTuple):
    """Uniform CR knot table for a scalar function on [0, x_max).

    ``values`` holds f at knots -1 .. depth+2; ``windows`` is the
    [depth, 4] per-segment control-point window (the paper's LUT plus
    neighbour wiring). ``windows`` may be replaced by a float32 tensor
    (the model's trainable leaf) via ``_replace``."""

    x_max: float
    depth: int            # number of segments in [0, x_max)
    period: float         # x_max / depth (the paper's "sampling period")
    values: np.ndarray    # [depth + 4] knot values, f((k-1)*period), k=0..depth+3
    windows: np.ndarray   # [depth, 4] -> values[k-1 : k+3] for segment k
    saturation: float     # f(x) for x >= x_max (odd-extended for x <= -x_max)


def build_table(fn: Callable[[np.ndarray], np.ndarray], x_max: float, depth: int,
                saturation: float | None = None) -> SplineTable:
    """Build a CR knot table for ``fn`` sampled uniformly on [0, x_max]
    (float64 numpy, byte-identical to the reference builder)."""
    period = x_max / depth
    ks = np.arange(-1, depth + 3, dtype=np.float64)  # -1 .. depth+2
    values = fn(ks * period).astype(np.float64)
    if saturation is None:
        saturation = float(fn(np.asarray([x_max], dtype=np.float64))[0])
    idx = np.arange(depth)[:, None] + np.arange(4)[None, :]
    windows = values[idx]
    return SplineTable(float(x_max), int(depth), float(period), values, windows,
                       float(saturation))


def _segment(table: SplineTable, x, odd: bool):
    """(|x| or x, segment index int64, local t) with the reference's
    division-based index split."""
    ax = torch.abs(x) if odd else x
    u = ax / table.period
    k = torch.clamp(torch.floor(u), 0, table.depth - 1).to(torch.int64)
    t = u - k.to(u.dtype)                          # in [0,1)
    return ax, k, t


def _finish(y, x, ax, table: SplineTable, odd: bool):
    sat = torch.tensor(table.saturation, dtype=y.dtype, device=y.device)
    y = torch.where(ax >= table.x_max, sat, y)
    if odd:
        y = torch.where(x < 0, -y, y)
    return y.to(x.dtype)


def interpolate(table: SplineTable, x, odd: bool = True):
    """Float CR interpolation of the tabled function at x.

    ``odd=True`` applies the paper's odd-symmetry trick: evaluate on |x|
    and restore the sign. Out-of-range |x| >= x_max saturates."""
    x = torch.as_tensor(x)
    ax, k, t = _segment(table, x, odd)
    w = basis_weights(t)                           # [..., 4]
    windows = torch.as_tensor(table.windows, dtype=x.dtype, device=x.device)
    p = windows[k]                                 # [..., 4]
    y = torch.sum(p * w, dim=-1)
    return _finish(y, x, ax, table, odd)


def interpolate_pwl(table: SplineTable, x, odd: bool = True):
    """Piecewise-linear interpolation over the same knots (paper baseline)."""
    x = torch.as_tensor(x)
    ax, k, t = _segment(table, x, odd)
    knots = torch.as_tensor(table.values, dtype=x.dtype, device=x.device)
    y0 = knots[k + 1]      # values is offset by one (k=-1 stored at 0)
    y1 = knots[k + 2]
    y = y0 + t * (y1 - y0)
    return _finish(y, x, ax, table, odd)
