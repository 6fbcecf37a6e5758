"""The Approximant API: one interface for every activation datapath.

Counterpart of ``repro/core/approximant.py``. Consumers program against
three things:

  * ``ApproxSpec`` — the hashable static geometry of an approximant
    (scheme name, LUT depth / degree, domain, symmetry, fixed-point
    format);
  * ``build(spec, target)`` — host-side numpy parameter construction,
    returning ONE flat float32 2D array per scheme (cr_spline:
    [depth, 4] CR control-point windows);
  * ``block(v, params, spec)`` — the pure f32 datapath on a tensor,
    the plain version every kernel is held against.

Registered in this slice: ``cr_spline`` (the paper), float ``build`` and
``block``. The ``pwl`` / ``poly`` / ``rational`` schemes and every
scheme's fixed datapath (``build_fixed`` / ``fixed_block`` /
``requantize``) are still to be ported (ROADMAP.md, Queue A items 2-3,
Queue B); until then ``get`` rejects their names as unregistered.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from . import catmull_rom as cr
from .fixed_point import GUARD_BITS, QFormat


@dataclasses.dataclass(frozen=True)
class ApproxSpec:
    """Static geometry of an approximant (everything but the params).
    ``period`` is a real field so CR specs built from a ``SplineTable``
    carry the table's own float period bit for bit."""

    period: float | None = None   # segment width; None -> x_max / depth
    depth: int = 32               # LUT segments (cr_spline / pwl / poly)
    x_max: float = 4.0            # approximation domain [0, x_max)
    saturation: float = 0.999329299739067   # output at/beyond x_max
    scheme: str = "cr_spline"
    degree: int = 3               # poly: per-segment degree;
                                  # rational: continued-fraction order
    odd: bool = True              # odd-symmetric target (tanh family)
    int_bits: int = 2             # fixed-point format of the hardware
    frac_bits: int = 13           # datapath this spec models (Q2.13)

    def __post_init__(self):
        if self.period is None:
            object.__setattr__(self, "period", self.x_max / self.depth)

    @property
    def inv_period(self) -> float:
        return 1.0 / self.period

    @property
    def qformat(self) -> QFormat:
        return QFormat(self.int_bits, self.frac_bits)

    @property
    def guard_format(self) -> QFormat:
        return QFormat(self.int_bits, self.frac_bits + GUARD_BITS)

    @property
    def t_bits(self) -> int:
        """Low bits of the input magnitude forming the local t (needs one
        period to be a power-of-two number of LSBs)."""
        t_scaled = self.period * self.qformat.scale
        tb = int(round(np.log2(t_scaled)))
        if 2 ** tb != int(round(t_scaled)):
            raise ValueError(
                f"period {self.period} is not a power-of-two number of "
                f"LSBs in {self.qformat} — the fixed datapath's index/t "
                f"bit-slice needs pow2 depth over a pow2 domain")
        return tb

    @classmethod
    def of(cls, table: cr.SplineTable) -> "ApproxSpec":
        """The CR spec of a built spline table."""
        return cls(period=table.period, depth=table.depth,
                   x_max=table.x_max, saturation=table.saturation,
                   scheme="cr_spline")


# target name -> (numpy fn on [0, x_max], odd symmetric?)
TARGETS: dict[str, tuple[Callable, bool]] = {
    "tanh": (np.tanh, True),
    # the softplus epilogue's even residual h(u) = log(1 + e^-u)
    "softplus_res": (lambda u: np.log1p(np.exp(-u)), False),
}


def _target_fn(target: str) -> Callable:
    try:
        return TARGETS[target][0]
    except KeyError:
        raise ValueError(f"unknown approximant target {target!r}; "
                         f"have {sorted(TARGETS)}") from None


_REGISTRY: dict[str, "Approximant"] = {}


def register(cls):
    """Class decorator: instantiate and register an Approximant."""
    inst = cls()
    _REGISTRY[inst.scheme] = inst
    return cls


def schemes() -> tuple[str, ...]:
    """All registered scheme names (registration order)."""
    return tuple(_REGISTRY)


def get(scheme: str) -> "Approximant":
    try:
        return _REGISTRY[scheme]
    except KeyError:
        raise ValueError(f"unknown approximant scheme {scheme!r}; "
                         f"registered: {sorted(_REGISTRY)}") from None


class Approximant:
    """One approximation scheme: spec defaults + params + datapath."""

    scheme: str = "?"
    hardware = "?"
    default_geometry: dict = {}

    def spec(self, target: str = "tanh", *, x_max: float = 4.0,
             depth: int = 32, degree: int = 3, int_bits: int = 2,
             frac_bits: int = 13) -> ApproxSpec:
        fn = _target_fn(target)
        odd = TARGETS[target][1]
        return ApproxSpec(
            depth=depth, x_max=x_max,
            saturation=float(fn(np.asarray([x_max], np.float64))[0]),
            scheme=self.scheme, degree=degree, odd=odd,
            int_bits=int_bits, frac_bits=frac_bits)

    def params_shape(self, spec: ApproxSpec) -> tuple[int, int]:
        raise NotImplementedError

    def build(self, spec: ApproxSpec, target: str = "tanh") -> np.ndarray:
        """Host-side parameter construction (float64 fit -> f32 array)."""
        raise NotImplementedError

    def block(self, v, params, spec: ApproxSpec, *, lookup: str = "take",
              odd: bool | None = None):
        """Pure f32 datapath on a tensor."""
        raise NotImplementedError

    def build_fixed(self, *args, **kwargs):
        """Integer ROM / datapath / requantization of the fixed datapath."""
        raise NotImplementedError(
            "fixed-point datapaths are not ported yet (ROADMAP.md, Queue A "
            "item 2)")

    fixed_block = requantize = build_fixed


def spec_for(scheme: str, act: str = "tanh", *, x_max: float = 4.0,
             depth: int = 32, degree: int = 3, int_bits: int = 2,
             frac_bits: int = 13) -> ApproxSpec:
    """The spec an *epilogue* reads: tanh-family epilogues share one tanh
    approximant; softplus uses the even residual target, widened to
    x_max >= 8, depth >= 64."""
    if act == "softplus":
        return get(scheme).spec("softplus_res", x_max=max(x_max, 8.0),
                                depth=max(depth, 64), degree=degree,
                                int_bits=int_bits, frac_bits=frac_bits)
    return get(scheme).spec("tanh", x_max=x_max, depth=depth, degree=degree,
                            int_bits=int_bits, frac_bits=frac_bits)


def target_of(act: str) -> str:
    """Epilogue name -> approximant target name."""
    return "softplus_res" if act == "softplus" else "tanh"


@lru_cache(maxsize=None)
def params_for(spec: ApproxSpec, target: str = "tanh") -> np.ndarray:
    """Cached ``build`` (specs are hashable; params are host numpy)."""
    return get(spec.scheme).build(spec, target)


def block(v, params, spec: ApproxSpec, *, lookup: str = "take",
          odd: bool | None = None):
    """Generic datapath dispatch."""
    return get(spec.scheme).block(v, params, spec, lookup=lookup, odd=odd)


def reference(x, spec: ApproxSpec, target: str = "tanh"):
    """Approximate ``target`` at x via ``spec`` (f32 math, f32 params,
    result in x's dtype)."""
    x = torch.as_tensor(x)
    p = torch.as_tensor(params_for(spec, target), device=x.device)
    return block(x.to(torch.float32), p, spec).to(x.dtype)


@register
class CRSpline(Approximant):
    """Catmull-Rom spline LUT (the paper's Fig. 2/3 unit). The block is
    ``kernels/epilogue.py::_cr_tanh_block``, as in the reference."""

    scheme = "cr_spline"
    hardware = "CR window LUT + integer-coeff basis MAC (paper Fig. 2/3)"
    default_geometry = {"depth": 32}

    def params_shape(self, spec):
        return (spec.depth, 4)

    def build(self, spec, target="tanh"):
        tab = cr.build_table(_target_fn(target), spec.x_max, spec.depth,
                             saturation=spec.saturation)
        return np.asarray(tab.windows, np.float32)

    def block(self, v, params, spec, *, lookup="take", odd=None):
        from repro_torch.kernels.epilogue import _cr_tanh_block
        return _cr_tanh_block(v, params, spec=spec, lookup=lookup,
                              odd=spec.odd if odd is None else odd)
