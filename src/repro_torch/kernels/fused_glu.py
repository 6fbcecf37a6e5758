"""Fused GLU matmuls + CR-spline activation: the GLU instance of the
shared epilogue kernel (see ``epilogue.py``).

    out = epilogue(x @ w_gate) * (x @ w_up)

This file only re-binds the entry point."""
from __future__ import annotations

import torch

from .epilogue import (  # noqa: F401  (re-exported: shared datapath)
    EPILOGUES,
    TableSpec,
    _cr_tanh_block,
    glu_2d,
)


def fused_glu_2d(x, w_gate, w_up, windows, *, period: float, x_max: float,
                 saturation: float, act: str = "silu",
                 lookup: str = "onehot"):
    """out[M,N] = act_cr(x[M,K] @ w_gate[K,N]) * (x @ w_up)."""
    spec = TableSpec(period=period, depth=windows.shape[0], x_max=x_max,
                     saturation=saturation)
    return glu_2d(x, w_gate, w_up,
                  torch.as_tensor(windows, dtype=torch.float32,
                                  device=x.device),
                  spec=spec, act=act, lookup=lookup)
