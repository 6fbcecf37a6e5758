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
pick their own tiles, and the device picks the route.

Autodiff: each kernel call is a ``torch.autograd.Function`` (``_ActCore``,
``_FusedGluCore``; the reference's ``custom_vjp``) whose forward is the
kernel (CUDA) or its plain version (CPU) and whose backward recomputes
the kernel's plain version in torch, f32 math with the "take" lookup, and
differentiates that (``_act_ref_math``, ``_fused_glu_ref_math``). The
backward launches no kernel and keeps no residual from inside the kernel:
the forward saves only its inputs, the approximant's params tensor among
them, so a trainable ``params["act"]`` leaf gets its gradient on every
route.
"""
from __future__ import annotations

import functools

import numpy as np
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
    if isinstance(p, np.ndarray):
        p = np.ascontiguousarray(p, np.float32)
        return spec, _host_params_on(p.tobytes(), p.shape,
                                     torch.device(device))
    return spec, torch.as_tensor(p, dtype=torch.float32,
                                 device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _host_params_on(data: bytes, shape: tuple, device: torch.device):
    """Host f32 params (a CR table's knot windows) on ``device``, copied
    there once per distinct array, as ``approximant.params_on`` does: the
    softplus epilogue reads its own table, never a bound leaf, in every
    Mamba decode step."""
    return torch.frombuffer(bytearray(data), dtype=torch.float32).reshape(
        shape).to(device)


def _recompute_grads(fn, inputs, needs, g):
    """Gradients of ``fn(*inputs)`` against ``g`` for the inputs flagged in
    ``needs`` (None for the rest), by differentiating a fresh recompute."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        y = fn(*leaves)
        got = iter(torch.autograd.grad(
            y, [t for t, n in zip(leaves, needs) if n], g))
    return tuple(next(got) if n else None for n in needs)


def _act_ref_math(spec, act, x, params):
    """Recompute of the element-wise epilogue for the backward pass: the
    kernel's plain version (f32 math, "take" lookup, cast to x's dtype)."""
    return epi.elementwise_2d_plain(x, params, spec=spec, act=act,
                                    lookup="take")


class _ActCore(torch.autograd.Function):
    """``elementwise_2d`` forward, recompute backward."""

    @staticmethod
    def forward(ctx, x, params, spec, act, lookup):
        ctx.spec, ctx.act = spec, act
        ctx.save_for_backward(x, params)
        return epi.elementwise_2d(x, params, spec=spec, act=act,
                                  lookup=lookup)

    @staticmethod
    def backward(ctx, g):
        fn = functools.partial(_act_ref_math, ctx.spec, ctx.act)
        return _recompute_grads(fn, ctx.saved_tensors,
                                ctx.needs_input_grad[:2], g) + (None,) * 3


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
    y = _ActCore.apply(x.reshape(rows, cols).contiguous(), p, spec, name,
                       lookup)
    return y.reshape(shape)


def cr_act(x, table: cr.SplineTable | None = None, *, lookup: str = "onehot",
           interpret: bool | None = None, block_rows: int | None = None,
           block_cols: int | None = None):
    """CR-spline tanh; ``table`` defaults to the paper's flagship
    (x_max=4, depth=32)."""
    return act(x, "tanh", table or tanh_table(4.0, 32), lookup=lookup)


def _fused_glu_ref_math(spec, act, x, w_gate, w_up, params):
    """Unfused recompute for the backward pass: the kernel's plain version
    (f32 matmuls of the upcast inputs, the same epilogue on the gate
    product, "take" lookup, cast to x's dtype)."""
    return epi.glu_2d_plain(x, w_gate, w_up, params, spec=spec, act=act,
                            lookup="take")


class _FusedGluCore(torch.autograd.Function):
    """``glu_2d`` forward, recompute backward."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, params, spec, act, lookup):
        ctx.spec, ctx.act = spec, act
        ctx.save_for_backward(x, w_gate, w_up, params)
        return epi.glu_2d(x, w_gate, w_up, params, spec=spec, act=act,
                          lookup=lookup)

    @staticmethod
    def backward(ctx, g):
        fn = functools.partial(_fused_glu_ref_math, ctx.spec, ctx.act)
        return _recompute_grads(fn, ctx.saved_tensors,
                                ctx.needs_input_grad[:4], g) + (None,) * 3


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
    y = _FusedGluCore.apply(x.reshape(-1, k).contiguous(),
                            w_gate.contiguous(), w_up.contiguous(), p, spec,
                            act, lookup)
    return y.reshape(tuple(shape[:-1]) + (n,))
