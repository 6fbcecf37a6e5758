"""Q-format fixed-point helpers (the float-facing half).

Counterpart of ``repro/core/fixed_point.py``. This slice carries what
``ApproxSpec`` and the activation engine reference: the format type,
the paper's Q2.13 constant, the guard-bit width and the quantize /
dequantize / saturate primitives. The integer MAC lowerings
(``fx_mul_shift``, ``LimbStack``, ``fx_dot4``) arrive with the
fixed-point datapaths (ROADMAP.md, Queue A item 2).
"""
from __future__ import annotations

import dataclasses

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
    as ``jnp.round`` does."""
    if rounding not in ("nearest", "floor"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if isinstance(x, (np.ndarray, np.floating, float)):
        scaled = np.asarray(x, np.float64) * fmt.scale
        q = np.round(scaled) if rounding == "nearest" else np.floor(scaled)
        return np.clip(q, fmt.min_int, fmt.max_int).astype(np.int32)
    scaled = x * fmt.scale
    q = torch.round(scaled) if rounding == "nearest" else torch.floor(scaled)
    return torch.clamp(q, fmt.min_int, fmt.max_int).to(torch.int32)


def dequantize(q, fmt: QFormat = Q2_13):
    return q.to(torch.float32) * fmt.resolution


def sat(q, fmt: QFormat = Q2_13):
    """Saturate an int32 lattice value into fmt's representable range."""
    return torch.clamp(q, fmt.min_int, fmt.max_int)
