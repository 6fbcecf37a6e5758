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


# the backward's batched one-hot product: rows a tile, one-hot elements a
# chunk (128 MB at f32)
_TILE, _CHUNK = 1024, 1 << 25


class _TableRows(torch.autograd.Function):
    """``table[k]`` for int64 indices ``k``, differentiable in the table,
    built for a table of a few dozen rows read at millions of indices.
    ``table[k]`` (and ``index_select``) gather such rows at ~1.9 ms for a
    [1024, 3072] lookup on an H100, and differentiate to an indexed
    scatter-add that sorts the indices, walks each row's run of duplicates
    in one warp and took 150 ms (``chip_smoke.py``, ``trace_train``).
    Here the forward is ``torch.take`` at flat offsets, and the backward
    sums the gradient rows into the table's rows by a one-hot product per
    tile of ``_TILE`` indices (a batched matmul) and a sum over tiles,
    in f32 or wider: no atomics, so the same inputs give the same bits,
    and nothing makes the host wait."""

    @staticmethod
    def forward(ctx, table, k):
        ctx.save_for_backward(k)
        ctx.table_shape = tuple(table.shape)
        return torch.take(table, _flat_index(k, table.shape))

    @staticmethod
    def backward(ctx, g):
        (k,) = ctx.saved_tensors
        depth = ctx.table_shape[0]
        cols = int(np.prod(ctx.table_shape[1:]))
        acc = torch.promote_types(g.dtype, torch.float32)
        flat = k.reshape(-1)
        gf = g.reshape(-1, cols).to(acc)
        tiles = -(-flat.numel() // _TILE)
        pad = tiles * _TILE - flat.numel()
        if pad:          # an index past the table has an all-zero one-hot row
            flat = torch.nn.functional.pad(flat, (0, pad), value=depth)
            gf = torch.nn.functional.pad(gf, (0, 0, 0, pad))
        flat = flat.view(tiles, _TILE, 1)
        gf = gf.view(tiles, _TILE, cols)
        ids = torch.arange(depth, device=g.device)
        grad = torch.zeros((depth, cols), dtype=acc, device=g.device)
        per = max(1, _CHUNK // (_TILE * depth))
        for i in range(0, tiles, per):
            onehot = (flat[i:i + per] == ids).to(acc)      # [t, _TILE, depth]
            grad += torch.bmm(onehot.transpose(1, 2), gf[i:i + per]).sum(0)
        return grad.to(g.dtype).reshape(ctx.table_shape), None


def _flat_index(k, shape):
    """Flat offsets of rows ``k`` of a contiguous table of ``shape``:
    [..., C] for a [depth, C] table, ``k`` itself for a 1-D one."""
    if len(shape) == 1:
        return k
    cols = int(np.prod(shape[1:]))
    offs = k[..., None] * cols + torch.arange(cols, device=k.device)
    return offs.reshape(tuple(k.shape) + tuple(shape[1:]))


def table_lookup(table, k):
    """Rows ``table[k]`` (int64 ``k`` of any shape, a table of any rank >=
    1), differentiable in the table; see ``_TableRows``."""
    return _TableRows.apply(table, k)


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
    # a NaN input takes segment 0 (t, and so the output, stay NaN): its
    # integer cast would index out of bounds
    k = torch.nan_to_num(torch.clamp(torch.floor(u), 0, table.depth - 1)
                         ).to(torch.int64)
    t = u - k.to(u.dtype)                          # in [0,1)
    return ax, k, t


def _finish(y, x, ax, table: SplineTable, odd: bool):
    # a Python scalar, cast by the op to y's dtype: a tensor made from it
    # on the card would be a copy from host memory and a host sync
    y = torch.where(ax >= table.x_max, float(table.saturation), y)
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
    p = table_lookup(windows, k)                   # [..., 4]
    y = torch.sum(p * w, dim=-1)
    return _finish(y, x, ax, table, odd)


def interpolate_pwl(table: SplineTable, x, odd: bool = True):
    """Piecewise-linear interpolation over the same knots (paper baseline)."""
    x = torch.as_tensor(x)
    ax, k, t = _segment(table, x, odd)
    knots = torch.as_tensor(table.values, dtype=x.dtype, device=x.device)
    y0 = table_lookup(knots, k + 1)   # values is offset by one (k=-1 at 0)
    y1 = table_lookup(knots, k + 2)
    y = y0 + t * (y1 - y0)
    return _finish(y, x, ax, table, odd)
