"""Element-wise CR-spline tanh: the matmul-free instance of the shared
epilogue kernel (see ``epilogue.py``); this file only binds
``act="tanh"``."""
from __future__ import annotations

import torch

from .epilogue import (  # noqa: F401  (re-exported: shared datapath)
    TableSpec,
    _basis_weights_f32,
    _cr_tanh_block,
    elementwise_2d,
)


def cr_act_2d(x, windows, *, period: float, x_max: float, saturation: float,
              lookup: str = "onehot"):
    """Apply the CR-spline tanh to a 2D tensor."""
    spec = TableSpec(period=period, depth=windows.shape[0], x_max=x_max,
                     saturation=saturation)
    return elementwise_2d(x, torch.as_tensor(windows, dtype=torch.float32,
                                             device=x.device),
                          spec=spec, act="tanh", lookup=lookup)
