"""Error analysis reproducing the paper's Tables I and II.

Counterpart of ``repro/core/error_analysis.py``. The paper integrates the
approximation error over the full 16-bit signed input lattice on (-4, 4)
(Q2.13). Four datapaths per method:

  float      float table, float arithmetic
  qlut       Q2.13-quantized LUT entries, float arithmetic
  qout       qlut + output rounded to Q2.13                  <- paper's tables
  fixed      full bit-accurate integer datapath, any registered scheme
             (Fig. 3 circuit for CR; value+delta MAC for PWL; truncating
             Horner chain for poly; Newton-reciprocal Pade for rational)

At depth 64 the paper's CR max error is exactly one LSB (2^-13 = 0.000122).

The reference takes the float grid's precision from jax's global 64-bit
flag; here it is the ``dtype`` argument (float32 by default, float64 for
the reference's 64-bit mode). The datapaths run on ``device``, the card
unless the caller passes ``device="cpu"``; without a card the default
raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import approximant
from . import catmull_rom as cr
from .fixed_point import (GUARD_BITS, Q2_13, QFormat, dequantize, quantize,
                          representable_grid)

# Paper Tables I and II: sampling period -> (depth, pwl_rms, cr_rms, pwl_max, cr_max)
PAPER_TABLE_1_2 = {
    0.5:    dict(depth=8,  pwl_rms=0.008201, cr_rms=0.001462, pwl_max=0.023330, cr_max=0.005179),
    0.25:   dict(depth=16, pwl_rms=0.002078, cr_rms=0.000147, pwl_max=0.006015, cr_max=0.000602),
    0.125:  dict(depth=32, pwl_rms=0.000523, cr_rms=0.000052, pwl_max=0.001584, cr_max=0.000152),
    0.0625: dict(depth=64, pwl_rms=0.000135, cr_rms=0.000049, pwl_max=0.000470, cr_max=0.000122),
}


@dataclasses.dataclass
class ErrorStats:
    rms: float
    max: float
    mean_abs: float

    def row(self):
        return (self.rms, self.max)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("error_analysis(device='cuda'): no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "datapaths on the CPU")
    return device


def _host(y) -> np.ndarray:
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _stats(approx, exact: np.ndarray) -> ErrorStats:
    err = _host(approx).astype(np.float64) - exact.astype(np.float64)
    return ErrorStats(
        rms=float(np.sqrt(np.mean(err ** 2))),
        max=float(np.max(np.abs(err))),
        mean_abs=float(np.mean(np.abs(err))),
    )


def _quantized_table(x_max: float, depth: int, fmt: QFormat) -> cr.SplineTable:
    tab = cr.build_table(np.tanh, x_max, depth)
    qv = np.asarray(dequantize(quantize(tab.values, fmt), fmt), dtype=np.float64)
    qw = np.asarray(dequantize(quantize(tab.windows, fmt), fmt), dtype=np.float64)
    sat = float(dequantize(quantize(np.float64(tab.saturation), fmt), fmt))
    return cr.SplineTable(tab.x_max, tab.depth, tab.period, qv, qw, sat)


def tanh_error(method: str, depth: int, x_max: float = 4.0,
               datapath: str = "qlut", fmt: QFormat = Q2_13,
               degree: int = 3, *, dtype: torch.dtype = torch.float32,
               device="cuda") -> ErrorStats:
    """Error of ``method`` at ``depth`` over the full Q-format grid, for
    the given datapath in {'float','qlut','qout','fixed'}.

    ``method`` is 'cr'/'pwl' (the paper's Table I/II pair, on the float64
    knot-table codepath) or any registered approximant scheme
    ('cr_spline' aliases 'cr'; 'poly'/'rational' take ``degree``). The
    fixed datapath is the bit-accurate integer circuit of any registered
    scheme (``approximant.fixed_block``) with ``fmt`` as the Q format.
    ``dtype`` is the float grid's precision on the cr/pwl float paths
    (the other schemes' blocks run in f32, as in the reference)."""
    device = _device(device)
    grid = representable_grid(fmt)          # float64 [2^(1+int+frac)]
    exact = np.tanh(grid)
    x = torch.as_tensor(grid, dtype=dtype, device=device)
    if method == "cr_spline":
        method = "cr"

    if datapath == "fixed":
        scheme = "cr_spline" if method == "cr" else method
        if scheme not in approximant.schemes():
            raise ValueError(
                f"datapath='fixed' needs a registered approximant scheme "
                f"with an integer datapath, got {method!r}; registered: "
                f"{sorted(approximant.schemes())}")
        spec = approximant.spec_for(scheme, "tanh", x_max=x_max,
                                    depth=depth, degree=degree,
                                    int_bits=fmt.int_bits,
                                    frac_bits=fmt.frac_bits)
        params_q = approximant.fixed_params_on(spec, "tanh", device)
        # host float64 -> exact lattice
        xq = torch.as_tensor(quantize(grid, fmt), device=device)
        y = dequantize(approximant.fixed_block(xq, params_q, spec), fmt)
        return _stats(y, exact)

    if datapath not in ("float", "qlut", "qout"):
        raise ValueError(f"unknown datapath {datapath!r}")

    if method in ("cr", "pwl"):
        if datapath == "float":
            tab = cr.build_table(np.tanh, x_max, depth)
        else:
            tab = _quantized_table(x_max, depth, fmt)
        fn = cr.interpolate if method == "cr" else cr.interpolate_pwl
        y = _host(fn(tab, x))
    else:
        spec = approximant.spec_for(method, "tanh", x_max=x_max,
                                    depth=depth, degree=degree)
        params = approximant.params_for(spec, "tanh")
        if datapath in ("qlut", "qout"):
            # coefficient ROM with GUARD_BITS guard bits below the datapath
            # LSB, the ROM format the fixed datapath carries
            cfmt = QFormat(fmt.int_bits, fmt.frac_bits + GUARD_BITS)
            params = dequantize(quantize(params.astype(np.float64), cfmt),
                                cfmt)
        y = _host(approximant.block(
            x.to(torch.float32),
            torch.as_tensor(params, dtype=torch.float32, device=device),
            spec))
    if datapath == "qout":
        y = dequantize(quantize(y, fmt), fmt)
    return _stats(y, exact)


def table_1_2(datapath: str = "qout", *, dtype: torch.dtype = torch.float32,
              device="cuda") -> list[dict]:
    """Regenerate paper Tables I & II. Returns one row per sampling period."""
    rows = []
    for period, ref in PAPER_TABLE_1_2.items():
        depth = ref["depth"]
        pwl = tanh_error("pwl", depth, datapath=datapath, dtype=dtype,
                         device=device)
        crs = tanh_error("cr", depth, datapath=datapath, dtype=dtype,
                         device=device)
        rows.append(dict(
            period=period, depth=depth,
            pwl_rms=pwl.rms, cr_rms=crs.rms,
            rms_gain=pwl.rms / crs.rms,
            pwl_max=pwl.max, cr_max=crs.max,
            max_gain=pwl.max / crs.max,
            paper=ref,
        ))
    return rows


def generic_error(engine_fn, exact_fn, lo: float, hi: float,
                  n: int = 200001, *, device="cuda") -> ErrorStats:
    """Error of an arbitrary activation backend vs its exact counterpart
    over a dense f32 grid on ``device`` (sigmoid/silu/gelu/softplus
    accuracy)."""
    device = _device(device)
    grid = np.linspace(lo, hi, n)
    exact = exact_fn(grid)
    y = engine_fn(torch.as_tensor(grid, dtype=torch.float32, device=device))
    return _stats(y, exact)
