"""Plain torch oracles for every kernel in this package.

Counterpart of ``repro/kernels/ref.py``: same math, no tiling.
``epilogue_ref`` mirrors ``epilogue.make_epilogue`` term for term, on the
float CR interpolator (``catmull_rom.interpolate``).
"""
from __future__ import annotations

import torch

from repro_torch.core import catmull_rom as cr
from repro_torch.core.activations import SQRT_2_OVER_PI


def _tanh_ref(v, table: cr.SplineTable):
    return cr.interpolate(table, v)


def epilogue_ref(act: str, x, table: cr.SplineTable):
    """Oracle for one spline epilogue on an f32 tensor. ``table`` is the
    epilogue's own table (see ``epilogue.table_for``)."""
    if act == "tanh":
        return _tanh_ref(x, table)
    if act == "sigmoid":
        return 0.5 * (1.0 + _tanh_ref(x * 0.5, table))
    if act == "silu":
        return x * (0.5 * (1.0 + _tanh_ref(x * 0.5, table)))
    if act == "gelu_tanh":
        inner = SQRT_2_OVER_PI * (x + 0.044715 * x ** 3)
        return 0.5 * x * (1.0 + _tanh_ref(inner, table))
    if act == "softplus":
        return torch.relu(x) + cr.interpolate(table, torch.abs(x), odd=False)
    raise ValueError(act)


def act_ref(x, act: str, table: cr.SplineTable):
    """Oracle for ops.act: float CR epilogue in f32, cast back."""
    y = epilogue_ref(act, x.to(torch.float32), table)
    return y.to(x.dtype)


def cr_act_ref(x, table: cr.SplineTable):
    """Oracle for cr_act: float CR interpolation (odd, saturating)."""
    return act_ref(x, "tanh", table)


def fused_glu_ref(x, w_gate, w_up, table: cr.SplineTable, act: str = "silu"):
    """Oracle for fused_glu: unfused f32 matmuls + float CR epilogue."""
    xf = x.to(torch.float32)
    gate = xf @ w_gate.to(torch.float32)
    up = xf @ w_up.to(torch.float32)
    y = epilogue_ref(act, gate, table) * up
    return y.to(x.dtype)
