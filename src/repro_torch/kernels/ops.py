"""Public wrappers around the epilogue kernels.

Counterpart of ``repro/kernels/ops.py``. Handles arbitrary leading dims
(flattened to rows, 0-d inputs as one element), dtype pass-through and
approximant-scheme selection per epilogue. No padding: the CUDA kernels
mask their own ragged edges. A CPU tensor runs the kernel's plain
version, a CUDA tensor the kernel; the tensor's device is the only
switch.

  act(x, name, ...)            one-launch element-wise epilogue
  cr_act(x)                    the CR ``tanh`` instance
  fused_glu(x, wg, wu, ...)    GLU matmuls fused with an epilogue

The TPU tiling knobs (``block_rows`` / ``block_cols`` / ``block_m`` /
``block_n`` / ``block_k``) and ``interpret`` are accepted for call
compatibility with the reference and have no effect: the Hopper kernels
pick their own tiles, and the device picks the route. The recompute
backward (the reference's ``custom_vjp``) arrives with training as a
``torch.autograd.Function`` (ROADMAP.md, Queue A item 7).
"""
from __future__ import annotations

import torch

from repro_torch.core import approximant
from repro_torch.core import catmull_rom as cr
from repro_torch.core.activations import tanh_table

from . import epilogue as epi

EPILOGUES = epi.EPILOGUES


def _resolve_spec_params(act: str, table: cr.SplineTable | None,
                         method: str | None, spec, depth: int, degree: int,
                         x_max: float, device, params=None):
    """(spec, params) for one epilogue call. The CR route (explicit table,
    ``method`` unset or a CR alias) takes the spec from the SplineTable and
    params = its [depth, 4] windows in f32. Other schemes resolve through
    the approximant registry, whose built params are placed on the device
    once per (spec, target, device). ``params`` (the model's bound leaf,
    already on the device) replaces the built array, and then nothing is
    copied from the host: such a copy makes the host wait for the device,
    and the decode loop must enqueue its steps without waiting."""
    windows = None
    if spec is not None:
        if table is not None or method is not None:
            raise ValueError(
                "spec= fully determines the approximant; don't also pass "
                f"table/method (got method={method!r})")
    elif method in (None, "cr", "cr_spline"):
        table = table or epi.table_for(act, x_max, depth)
        spec, windows = epi.TableSpec.of(table), table.windows
    elif table is not None:
        raise ValueError(
            f"pass either a SplineTable (CR route) or method={method!r}, "
            "not both")
    else:
        spec = epi._spec_for_epilogue(act, method, x_max, depth, degree)
    if params is None and windows is None:
        return spec, approximant.params_on(spec, approximant.target_of(act),
                                           torch.device(device))
    p = windows if params is None else params
    return spec, torch.as_tensor(p, dtype=torch.float32,
                                 device=device).contiguous()


def act(x, name: str = "tanh", table: cr.SplineTable | None = None, *,
        method: str | None = None, spec: epi.ApproxSpec | None = None,
        params=None, depth: int = 32, degree: int = 3, x_max: float = 4.0,
        lookup: str = "onehot", interpret: bool | None = None,
        block_rows: int | None = None, block_cols: int | None = None):
    """Any approximant epilogue as ONE kernel launch (CUDA) or its plain
    version (CPU). Scheme selection, most specific wins: ``spec``, a CR
    ``table``, or ``method``. ``params`` overrides the registry-built
    parameter array (the model's bound leaf)."""
    x = torch.as_tensor(x)
    spec, p = _resolve_spec_params(name, table, method, spec, depth, degree,
                                   x_max, x.device, params)
    shape = x.shape
    cols = shape[-1] if len(shape) else 1          # 0-d: single element
    rows = x.numel() // cols if cols else 0
    y = epi.elementwise_2d(x.reshape(rows, cols).contiguous(), p, spec=spec,
                           act=name, lookup=lookup)
    return y.reshape(shape)


def cr_act(x, table: cr.SplineTable | None = None, *, lookup: str = "onehot",
           interpret: bool | None = None, block_rows: int | None = None,
           block_cols: int | None = None):
    """CR-spline tanh; ``table`` defaults to the paper's flagship
    (x_max=4, depth=32)."""
    return act(x, "tanh", table or tanh_table(4.0, 32), lookup=lookup)


def fused_glu(x, w_gate, w_up, table: cr.SplineTable | None = None, *,
              act: str = "silu", method: str | None = None,
              spec: epi.ApproxSpec | None = None, params=None,
              depth: int = 32, degree: int = 3, x_max: float = 4.0,
              lookup: str = "onehot", interpret: bool | None = None,
              block_m: int | None = None, block_n: int | None = None,
              block_k: int | None = None):
    """epilogue(x @ w_gate) * (x @ w_up) in ONE fused kernel launch (CUDA)
    or its plain version (CPU); selection as in ``act``."""
    spec, p = _resolve_spec_params(act, table, method, spec, depth, degree,
                                   x_max, x.device, params)
    shape = x.shape
    k = shape[-1]
    n = w_gate.shape[-1]
    y = epi.glu_2d(x.reshape(-1, k).contiguous(), w_gate.contiguous(),
                   w_up.contiguous(), p, spec=spec, act=act, lookup=lookup)
    return y.reshape(tuple(shape[:-1]) + (n,))
