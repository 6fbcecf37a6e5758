"""Cubic Catmull-Rom spline interpolation (paper Eq. 2/3).

Counterpart of ``repro/core/catmull_rom.py``: the basis, host-side knot
table construction (numpy, identical to the reference), the float
interpolators on tensors, and the bit-accurate fixed-point datapath of
the paper's Fig. 3 (``build_fixed_table``, ``interpolate_fixed``) on
int32 tensors.

``interpolate`` keeps the reference's numerics: it divides by the period
and casts the knot windows to the input's dtype, so a bf16 input is
interpolated in bf16 arithmetic, exactly as the reference's jnp path is.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .fixed_point import LimbStack, QFormat, Q2_13, fx_dot4, quantize

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


# ---------------------------------------------------------------------------
# Bit-accurate fixed-point datapath (paper Fig. 3)
# ---------------------------------------------------------------------------

class FixedTable(NamedTuple):
    """Quantized knot windows + index geometry for the Fig. 3 datapath.

    Depth and period are powers of two, so the index/t split of the
    input magnitude is a pure bit slice, as in hardware: the low
    ``t_bits`` bits are t and the bits above index the LUT.
    ``windows_q`` is host numpy as built; it may be replaced by an int32
    tensor already on the device (``_replace``)."""

    fmt: QFormat
    x_max: float
    depth: int
    t_bits: int           # number of low bits forming t
    windows_q: np.ndarray  # [depth, 4] int32 control points (Q fmt)
    sat_q: int            # saturated output value (Q fmt)


def build_fixed_table(fn, x_max: float, depth: int,
                      fmt: QFormat = Q2_13) -> FixedTable:
    table = build_table(fn, x_max, depth)
    # bits of the magnitude representing one period: period * scale = 2^t_bits
    t_scaled = table.period * fmt.scale
    t_bits = int(round(np.log2(t_scaled)))
    if 2 ** t_bits != int(round(t_scaled)):
        raise ValueError(
            f"period {table.period} is not a power-of-two number of LSBs in {fmt}"
        )
    windows_q = quantize(table.windows, fmt)
    sat_q = int(quantize(np.float64(table.saturation), fmt))
    return FixedTable(fmt, float(x_max), int(depth), t_bits, windows_q, sat_q)


def _wrap_i32(v: int) -> int:
    """Python int -> its int32 two's-complement representative."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def basis_weights_fixed(t_q, ftab: FixedTable):
    """Fixed-point basis evaluation: ``t_q`` is the raw low-bit residue
    (0 .. 2^t_bits - 1).

    t has only ``t_bits`` significant fractional bits, so t^2 and t^3 are
    exact with small multipliers, and the four integer-coefficient basis
    polynomials are computed exactly, aligned at 3*t_bits fractional
    bits: the only rounding in the datapath is the single shift-round at
    the MAC output.

    Returns int32 [..., 4], scaled 2^(3*t_bits+1) x the true basis value
    (the +1 carries the CR global 1/2, folded into the MAC's final
    shift), EXACT MOD 2^32. Two's-complement wraparound of the
    intermediates is harmless because every true basis value fits 32
    bits, with ONE exception: w1(t=0) = 2^(3tb+1) = 2^31 for tb=10,
    which wraps to -2^31. t = 0 is a knot hit, so ``interpolate_fixed``
    bypasses the MAC there (the hardware's index-hit mux).

    Wide geometries (t_bits > 10: depth 8/16 at Q2.13, depth <= 64 at
    Q2.16) exceed 32 lattice bits, so the basis comes back as a
    ``LimbStack`` of radix-2^s int32 limbs (``_wide_basis_limbs``)."""
    tb = ftab.t_bits
    if 3 * tb + 1 > 31:
        return _wide_basis_limbs(t_q, tb)
    T = t_q.to(torch.int32)                   # t * 2^tb, exact
    T2 = T * T                                # t^2 * 2^2tb, exact
    T3 = T2 * T                               # t^3 * 2^3tb, exact
    two_pow = _wrap_i32(2 << (3 * tb))        # 2^(3tb+1) mod 2^32
    # align everything at 3*tb fractional bits; all coefficients integer
    w0 = -T3 + 2 * (T2 << tb) - (T << (2 * tb))
    w1 = 3 * T3 - 5 * (T2 << tb) + two_pow
    w2 = -3 * T3 + 4 * (T2 << tb) + (T << (2 * tb))
    w3 = T3 - (T2 << tb)
    return torch.stack([w0, w1, w2, w3], dim=-1)


# Limb width for wide basis lattices: keeps every partial dot in fx_dot4
# exact on int32 lanes for formats up to Q2.18 (int+frac+s+2 <= 31) and
# every limb product here below 2^(s + t_bits) <= 2^25.
WIDE_LIMB_BITS = 10


def _wide_basis_limbs(t_q, tb: int, s: int = WIDE_LIMB_BITS) -> LimbStack:
    """Exact CR basis on a lattice wider than 31 bits, as radix-2^s limbs.

    The four basis values are integer combinations of T^3, T^2*2^tb,
    T*2^2tb and the constant 2^(3tb+1). T^2 is int32-exact (tb <= 15) but
    T^3 is not: it is formed by limb-splitting T^2 and multiplying each
    limb by T, and the shifted terms land piece-aligned via
    divmod(shift, s). One signed carry-normalize pass produces canonical
    limbs: 0..m-2 in [0, 2^s), the top one signed."""
    S = 3 * tb + 1                    # total lattice shift (incl. CR 1/2)
    m = -(-(S + 1) // s)              # limbs covering S+1 magnitude bits
    mask = (1 << s) - 1
    T = t_q.to(torch.int32)           # t * 2^tb, exact
    T2 = T * T                        # t^2 * 2^2tb, exact (2*tb <= 30)
    t2 = [(T2 >> (k * s)) & mask for k in range(-(-2 * tb // s))]
    t1 = [(T >> (k * s)) & mask for k in range(-(-tb // s))]
    zero = torch.zeros_like(T)
    q2, r2 = divmod(tb, s)            # T^2 << tb placement
    q1, r1 = divmod(2 * tb, s)        # T << 2tb placement
    qc, rc = divmod(S, s)             # constant 2^(3tb+1) placement

    def combine(c3: int, c2: int, c1: int, const: bool):
        acc = [zero] * m
        for k, piece in enumerate(t2):
            acc[k] = acc[k] + c3 * (piece * T)               # T^3 pieces
            acc[k + q2] = acc[k + q2] + c2 * (piece << r2)   # T^2 << tb
        if c1:
            for k, piece in enumerate(t1):
                acc[k + q1] = acc[k + q1] + c1 * (piece << r1)  # T << 2tb
        if const:
            acc[qc] = acc[qc] + (1 << rc)
        out, carry = [], zero
        for k in range(m - 1):
            v = acc[k] + carry
            out.append(v & mask)
            carry = v >> s            # arithmetic: exact floor
        out.append(acc[m - 1] + carry)
        return out

    ws = [combine(-1, 2, -1, False),      # w0 = -T3 + 2 T2<<tb - T<<2tb
          combine(3, -5, 0, True),        # w1 = 3 T3 - 5 T2<<tb + 2^(3tb+1)
          combine(-3, 4, 1, False),       # w2 = -3 T3 + 4 T2<<tb + T<<2tb
          combine(1, -1, 0, False)]       # w3 = T3 - T2<<tb
    limbs = tuple(torch.stack([w[k] for w in ws], dim=-1) for k in range(m))
    return LimbStack(s, limbs)


def take_rows(table_q, idx):
    """Rows ``table_q[idx]`` of a small int table (no gradient): one
    ``torch.take`` at flat offsets, which makes the host wait for
    nothing."""
    idx = idx.to(torch.int64)
    return torch.take(table_q, _flat_index(idx, table_q.shape))


def interpolate_fixed(ftab: FixedTable, x_q):
    """Bit-accurate CR interpolation on the integer lattice.

    ``x_q``: int32 Q-format input (e.g. from ``quantize``). Returns int32
    Q-format output. Mirrors Fig. 3: |x| -> (msbs -> LUT window, lsbs ->
    t), 4-tap MAC, sign fixup, saturation for |x| >= x_max."""
    fmt = ftab.fmt
    x_q = torch.as_tensor(x_q).to(torch.int32)
    sign_neg = x_q < 0
    mag = torch.abs(x_q)
    idx = mag >> ftab.t_bits
    in_range = idx < ftab.depth
    idx_c = torch.clamp(idx, 0, ftab.depth - 1)
    t_q = mag & ((1 << ftab.t_bits) - 1)
    w = basis_weights_fixed(t_q, ftab)   # [..., 4], frac = 3*t_bits (+CR 1/2)
    windows = torch.as_tensor(ftab.windows_q, dtype=torch.int32,
                              device=x_q.device)
    p = take_rows(windows, idx_c)        # [..., 4]
    # wide MAC: products at frac_bits + 3*t_bits fraction; ONE final
    # shift-round back to the output format (+1 folds the CR global 1/2)
    y = fx_dot4(p, w, fmt, extra_shift=3 * ftab.t_bits - fmt.frac_bits + 1)
    # t = 0 is an exact knot hit whose basis weight 2^(3tb+1) wraps the
    # 32-bit lattice (see basis_weights_fixed): bypass with the knot
    # value, which IS the exact MAC result there (hardware: index mux)
    y = torch.where(t_q == 0, p[..., 1], y)
    y = torch.where(in_range, y, ftab.sat_q)
    return torch.where(sign_neg, -y, y)


def interpolate_pwl(table: SplineTable, x, odd: bool = True):
    """Piecewise-linear interpolation over the same knots (paper baseline)."""
    x = torch.as_tensor(x)
    ax, k, t = _segment(table, x, odd)
    knots = torch.as_tensor(table.values, dtype=x.dtype, device=x.device)
    y0 = table_lookup(knots, k + 1)   # values is offset by one (k=-1 at 0)
    y1 = table_lookup(knots, k + 2)
    y = y0 + t * (y1 - y0)
    return _finish(y, x, ax, table, odd)
