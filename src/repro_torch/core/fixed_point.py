"""Q-format fixed-point arithmetic, bit-accurate with the paper's datapath.

Counterpart of ``repro/core/fixed_point.py``. The paper's unit is 16-bit
signed Q2.13 on (-4, 4). Every datapath value is an int32 lattice value,
so the ``*_fixed`` activation backends model the Fig. 3 circuit exactly:
products are truncated (or rounded) back to a target fraction width and
sums saturate, as a fixed-width MAC would.

Everything stays int32, as the reference runs: int32 products wrap in
two's complement (``basis_weights_fixed`` relies on it), partial dots
are summed with ``dtype=torch.int32`` (``torch.sum`` of int32 would
otherwise widen to int64), and wide products are split into partial
products that each fit 31 bits. The same ops run on a CPU or a CUDA
tensor and give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Signed fixed-point format: 1 sign bit, ``int_bits`` integer bits,
    ``frac_bits`` fraction bits."""

    int_bits: int
    frac_bits: int

    @property
    def total_bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def max_int(self) -> int:
        return (1 << (self.int_bits + self.frac_bits)) - 1

    @property
    def min_int(self) -> int:
        return -(1 << (self.int_bits + self.frac_bits))

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    def __str__(self) -> str:  # e.g. "Q2.13"
        return f"Q{self.int_bits}.{self.frac_bits}"


# The paper's format: 16-bit signed, range (-4, 4), resolution 2^-13.
Q2_13 = QFormat(int_bits=2, frac_bits=13)

# Guard bits carried by coefficient ROMs of MAC-chain schemes (poly /
# rational) below the datapath LSB.
GUARD_BITS = 6


def quantize(x, fmt: QFormat = Q2_13, rounding: str = "nearest"):
    """float -> integer lattice (int32), saturating.

    numpy inputs are quantized host-side in float64 and come back as a
    numpy int32 array (table building); tensors stay in their own
    precision (datapath emulation). ``torch.round`` rounds half to even,
    as ``jnp.round`` does. On a tensor NaN maps to 0, as the reference's
    jnp cast gives (a torch float-to-int32 cast of NaN is -2^31 on the
    CPU and may be 0 on a card); ±inf saturate."""
    if rounding not in ("nearest", "floor"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if isinstance(x, (np.ndarray, np.floating, float)):
        scaled = np.asarray(x, np.float64) * fmt.scale
        q = np.round(scaled) if rounding == "nearest" else np.floor(scaled)
        return np.clip(q, fmt.min_int, fmt.max_int).astype(np.int32)
    scaled = x * fmt.scale
    q = torch.round(scaled) if rounding == "nearest" else torch.floor(scaled)
    q = torch.nan_to_num(torch.clamp(q, fmt.min_int, fmt.max_int), nan=0.0)
    return q.to(torch.int32)


def dequantize(q, fmt: QFormat = Q2_13):
    """int32 lattice -> float32 (numpy in, numpy out)."""
    if isinstance(q, (np.ndarray, np.integer)):
        return np.asarray(q).astype(np.float32) * np.float32(fmt.resolution)
    return q.to(torch.float32) * fmt.resolution


def sat(q, fmt: QFormat = Q2_13):
    """Saturate an int32 lattice value into fmt's representable range."""
    return torch.clamp(q, fmt.min_int, fmt.max_int)


def fx_add(a, b, fmt: QFormat = Q2_13):
    """Saturating fixed-point add (same format in/out)."""
    return sat(a + b, fmt)


def fx_mul(a, b, fmt: QFormat = Q2_13, rounding: str = "floor"):
    """Fixed-point multiply: (a*b) >> frac_bits, truncating like hardware
    (``floor``, a wire shift) or with a rounding adder (``nearest``).

    The product is int32 and wraps past 2^31, which is what the
    reference computes: its int64 cast is an int32 one while jax runs
    with 64-bit types off, as it does by default."""
    prod = a.to(torch.int32) * b.to(torch.int32)
    if rounding == "floor":
        shifted = prod >> fmt.frac_bits
    elif rounding == "nearest":
        shifted = (prod + (1 << (fmt.frac_bits - 1))) >> fmt.frac_bits
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return sat(shifted, fmt)


def fx_mul_shift(a, b, shift: int, *, rounding: str = "floor",
                 a_bits: int = 15, b_bits: int = 15):
    """Exact wide product with one output shift on int32 lanes:
    ``(a*b [+ 2^(shift-1)]) >> shift``, the primitive MAC step of every
    fixed datapath (PWL slope MAC, truncating Horner stages, Newton
    reciprocal steps). The result is int32 and NOT saturated.

    ``a``/``b`` are int32 tensors (a 0-d one broadcasts).
    ``a_bits``/``b_bits`` are static magnitude bounds (|a| < 2^a_bits)
    that select the cheapest exact lowering, all int32-only:

      direct     a_bits + b_bits <= 30: one int32 product.
      2-piece    radix-2^s split of the wider operand with a progressive
                 carry, exact when the narrow operand times each piece
                 fits 31 bits and shift >= s.
      4-piece    both operands split at 2^13 into four partial products
                 with full carry propagation, exact for products up to
                 57 bits provided the shifted result fits int32.
    """
    if rounding not in ("floor", "nearest"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if shift < 0:
        raise ValueError(f"fx_mul_shift needs shift >= 0, got {shift}")
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    r_add = (1 << (shift - 1)) if (rounding == "nearest" and shift > 0) else 0
    if a_bits + b_bits <= 30:
        return (a * b + r_add) >> shift
    # 2-piece: split the WIDER operand so the narrow one multiplies each
    # piece: (a*b + R) >> shift == (a*b_hi + ((a*b_lo + R) >> s)) >> (shift-s)
    if a_bits > b_bits:
        a, b = b, a
        a_bits, b_bits = b_bits, a_bits
    s = b_bits + a_bits - 30                 # smallest exact piece split
    if 1 <= s <= shift and a_bits + s <= 30:
        mask = (1 << s) - 1
        lo = (a * (b & mask) + r_add) >> s
        return (a * (b >> s) + lo) >> (shift - s)
    # 4-piece: a = a1*2^13 + a0, b = b1*2^13 + b0 (hi arithmetic-shifted,
    # keeps sign; lo unsigned) -> four partials, each < 2^31; the
    # rounding addend folds in piece-aligned, then two carry
    # propagations reassemble the exact wide sum
    S = 13
    if a_bits + b_bits > 31 + 2 * S or max(a_bits, b_bits) > 31:
        raise ValueError(
            f"fx_mul_shift: {a_bits}+{b_bits}-bit product exceeds the "
            f"exact int32 4-piece decomposition (57 bits)")
    m = (1 << S) - 1
    a1, a0 = a >> S, a & m
    b1, b0 = b >> S, b & m
    c0 = a0 * b0 + (r_add & m)
    t1 = a1 * b0 + a0 * b1 + ((r_add >> S) & m) + (c0 >> S)
    t2 = a1 * b1 + (r_add >> (2 * S)) + (t1 >> S)
    if shift >= 2 * S:
        return t2 >> (shift - 2 * S)
    rem = ((t1 & m) << S) + (c0 & m)         # < 2^2S: fits, >= 0
    return (t2 << (2 * S - shift)) + (rem >> shift)


class LimbStack(NamedTuple):
    """A wide integer lattice value as radix-2^s limbs on int32 lanes.

    ``limbs[k]`` carries bits [k*s, (k+1)*s) of the represented value
    (little-endian): limbs 0..m-2 are non-negative residues in [0, 2^s),
    the top limb is signed. The represented value is
    sum_k limbs[k] * 2^(k*s), exact with no int64 anywhere: this is how
    ``basis_weights_fixed`` hands ``fx_dot4`` a basis lattice wider than
    31 bits (t_bits > 10 geometries)."""
    s: int          # limb width in bits
    limbs: tuple    # m int32 tensors [..., 4], least-significant first


def _dot(p, c):
    """int32 4-tap partial dot, kept int32 (``torch.sum`` widens int32 to
    int64 unless told otherwise)."""
    return torch.sum(p * c, dim=-1, dtype=torch.int32)


def fx_dot4(p, c, fmt: QFormat = Q2_13, rounding: str = "nearest",
            extra_shift: int = 0):
    """4-tap MAC: sum_i p[i]*c[i] with a wide accumulator, emulated
    EXACTLY on 32-bit lanes, then ONE shift-with-round and saturation.

    ``p``/``c``: int32 tensors whose last axis has length 4 (control
    points and basis values). ``c`` is split radix-2^s into three pieces
    (s = S//3, S the total output shift) and three int32 partial dots
    are carried with exact progressive carries. Exact when |p| < 2^15
    and every piece product fits 31 bits.

    ``c`` may instead be a ``LimbStack`` (a wide basis lattice): each limb
    is dotted separately and the partial sums carry-propagate before the
    single output shift-round, exact whenever
    int_bits + frac_bits + s + 2 <= 31 (checked)."""
    S = fmt.frac_bits + extra_shift
    if S < 3:
        raise ValueError(f"fx_dot4 output shift {S} too small to split")
    p32 = p.to(torch.int32)
    if isinstance(c, LimbStack):
        s, limbs = c.s, c.limbs
        m = len(limbs)
        p_bits = fmt.int_bits + fmt.frac_bits
        if p_bits + s + 2 > 31:
            raise ValueError(
                f"fx_dot4 limb dot overflows int32: |p| <= 2^{p_bits} "
                f"times 2^{s}-wide limbs, 4 taps needs "
                f"{p_bits + s + 2} <= 31 bits")
        if S < (m - 1) * s:
            raise ValueError(
                f"fx_dot4 output shift {S} below the top-limb offset "
                f"{(m - 1) * s}")
        mask = (1 << s) - 1
        accs = [_dot(p32, limb) for limb in limbs]
        if rounding == "nearest":
            # fold 2^(S-1) into the accumulators limb-aligned
            r = 1 << (S - 1)
            accs = [a + ((r >> (k * s)) & mask)
                    for k, a in enumerate(accs[:-1])] \
                + [accs[-1] + (r >> ((m - 1) * s))]
        carry = accs[0]
        for a in accs[1:]:
            carry = a + (carry >> s)
        return sat(carry >> (S - (m - 1) * s), fmt)
    s = S // 3                       # piece width; S >= 3s >= 2s + 1
    mask = (1 << s) - 1
    c32 = c.to(torch.int32)
    c_hi = c32 >> (2 * s)            # arithmetic: floor, keeps sign
    c_mid = (c32 >> s) & mask        # in [0, 2^s)
    c_lo = c32 & mask                # in [0, 2^s)
    a2 = _dot(p32, c_hi)
    a1 = _dot(p32, c_mid)
    a0 = _dot(p32, c_lo)
    # acc = a2*2^2s + a1*2^s + a0; fold the rounding addend 2^(S-1) into
    # the top piece, then carry-propagate so the final arithmetic shift
    # is an exact floor of (acc + round)/2^S
    if rounding == "nearest":
        a2 = a2 + (1 << (S - 1 - 2 * s))
    carry1 = a1 + (a0 >> s)
    carry2 = a2 + (carry1 >> s)
    return sat(carry2 >> (S - 2 * s), fmt)


def representable_grid(fmt: QFormat = Q2_13) -> np.ndarray:
    """Every representable value of ``fmt`` as float64 (exhaustive test
    grid): 2^16 = 65536 points spanning [-4, 4) for Q2.13."""
    ints = np.arange(fmt.min_int, fmt.max_int + 1, dtype=np.int64)
    return ints.astype(np.float64) / fmt.scale
