"""The Approximant API: one interface for every activation datapath.

Counterpart of ``repro/core/approximant.py``. Consumers program against
three things:

  * ``ApproxSpec`` — the hashable static geometry of an approximant
    (scheme name, LUT depth / degree, domain, symmetry, fixed-point
    format);
  * ``build(spec, target)`` — host-side numpy parameter construction
    (float64 fit), returning ONE flat float32 2D array per scheme:
        cr_spline  [depth, 4]       CR control-point windows
        pwl        [depth, 2]       segment (value, delta) pairs
        poly       [depth, deg+1]   per-segment Horner coefficients
        rational   [3, K]           Pade num/den in u = x^2 + Newton seed
  * ``block(v, params, spec)`` — the pure f32 datapath on a tensor,
    the plain version every kernel is held against.

  * ``build_fixed`` / ``fixed_block`` / ``requantize`` — the scheme's
    bit-accurate integer datapath: an int32 ROM, int32 lattice in and
    out, and the f32-params -> ROM requantization the bound
    ``<scheme>_fixed`` engines run on every call.

Registered schemes: ``cr_spline`` (the paper), ``pwl``, ``poly`` and
``rational``, each with its float and its fixed datapath.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from . import catmull_rom as cr
from .fixed_point import GUARD_BITS, QFormat, fx_mul_shift, quantize, sat

# Newton-iteration count for the rational scheme's reciprocal. With the
# equioscillating linear seed built into the params (error E < 0.6 for
# every domain swept), 5 iterations square the error to E^32 < 1e-7.
NEWTON_ITERS = 5


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

    def build_fixed(self, spec: ApproxSpec, target: str = "tanh") -> np.ndarray:
        """Integer parameter ROM (host numpy int32) of the scheme's fixed
        datapath. Default: the float params quantized to the guard-bit
        coefficient format (the MAC-chain schemes' ROM); the LUT-value
        schemes (cr_spline, pwl) quantize at the datapath format."""
        return quantize(self.build(spec, target).astype(np.float64),
                        spec.guard_format)

    def fixed_block(self, vq, params_q, spec: ApproxSpec):
        """Bit-accurate integer datapath: int32 lattice in
        (``spec.qformat``), int32 lattice out."""
        raise NotImplementedError

    def requantize(self, params, spec: ApproxSpec):
        """Tensor analogue of ``build_fixed`` on (possibly trained) f32
        params: the int32 ROM ``fixed_block`` reads, computed on the
        params' device. At the built params it reproduces
        ``build_fixed`` exactly."""
        return quantize(torch.as_tensor(params).to(torch.float32),
                        spec.guard_format)


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


@lru_cache(maxsize=None)
def params_on(spec: ApproxSpec, target: str, device) -> torch.Tensor:
    """``params_for`` as an f32 tensor on ``device``, copied there once:
    a copy from host memory makes the host wait for the device, and the
    decode loop must enqueue its steps without waiting."""
    return torch.as_tensor(params_for(spec, target), dtype=torch.float32,
                           device=device)


@lru_cache(maxsize=None)
def fixed_params_for(spec: ApproxSpec, target: str = "tanh") -> np.ndarray:
    """Cached integer ROM of ``spec``'s fixed datapath (host numpy int32)."""
    return get(spec.scheme).build_fixed(spec, target)


@lru_cache(maxsize=None)
def fixed_params_on(spec: ApproxSpec, target: str, device) -> torch.Tensor:
    """``fixed_params_for`` as an int32 tensor on ``device``, copied there
    once (see ``params_on``)."""
    return torch.as_tensor(fixed_params_for(spec, target), dtype=torch.int32,
                           device=device)


def fixed_block(vq, params_q, spec: ApproxSpec):
    """Generic bit-accurate datapath dispatch: int32 ``spec.qformat``
    lattice in and out. Numpy inputs (a host ROM, a host lattice) are
    copied to a tensor, onto ``vq``'s device for the ROM; the engines
    pass tensors already on their device."""
    vq = torch.as_tensor(vq).to(torch.int32)
    params_q = torch.as_tensor(params_q, device=vq.device).to(torch.int32)
    return get(spec.scheme).fixed_block(vq, params_q, spec)


def requantize(params, spec: ApproxSpec):
    """Generic f32-params -> int32-ROM dispatch (the trainable analogue of
    ``fixed_params_for``), what the bound ``<scheme>_fixed`` engines feed
    ``fixed_block``."""
    return get(spec.scheme).requantize(params, spec)


def reference(x, spec: ApproxSpec, target: str = "tanh"):
    """Approximate ``target`` at x via ``spec`` (f32 math, f32 params,
    result in x's dtype)."""
    x = torch.as_tensor(x)
    p = params_on(spec, target, x.device)
    return block(x.to(torch.float32), p, spec).to(x.dtype)


# ---------------------------------------------------------------------------
# shared datapath pieces
# ---------------------------------------------------------------------------

def _index_t_split(av, spec: ApproxSpec):
    """|x| -> (segment index int64, local t in [0,1)): one float multiply
    by the inverse period and a floor (hardware: a bit slice), shared by
    every LUT scheme."""
    u = av * spec.inv_period
    k = torch.clamp(torch.floor(u), 0.0, spec.depth - 1.0)
    # a NaN input takes segment 0 (t, and so the output, stay NaN): its
    # integer cast would index out of bounds
    return torch.nan_to_num(k).to(torch.int64), u - k


def _gather_columns(tableau, ki, lookup: str):
    """Row-gather of a [depth, C] f32 tableau at integer indices ``ki``;
    a tuple of C tensors shaped like ``ki``. The reference's "onehot" (an
    f32 one-hot dot) and "take" select the same rows, so both are one
    gather here."""
    if lookup not in ("onehot", "take"):
        raise ValueError(f"unknown lookup {lookup!r}")
    return tuple(cr.table_lookup(tableau, ki).unbind(-1))


def _finish(y, v, av, spec: ApproxSpec, odd: bool):
    """Shared epilogue of every scheme: clamp at the domain edge to the
    saturation constant (rounded to f32), then restore the sign for odd
    targets."""
    y = torch.where(av >= spec.x_max, _f32(spec.saturation), y)
    if odd:
        y = torch.where(v < 0.0, -y, y)
    return y


def _f32(a: float) -> float:
    """``a`` rounded to f32, as a Python float (exact in a f32 op)."""
    return float(np.float32(a))


# ---------------------------------------------------------------------------
# shared fixed-datapath pieces (int32 lattice; see core/fixed_point.py)
# ---------------------------------------------------------------------------

def _sat_q(spec: ApproxSpec) -> int:
    """The saturation constant on the output lattice (a wired constant in
    hardware), a Python int from host numpy, identical to
    ``build_fixed_table``'s sat_q."""
    fmt = spec.qformat
    q = np.round(np.float64(spec.saturation) * fmt.scale)
    return int(np.clip(q, fmt.min_int, fmt.max_int))


def _fixed_front(vq, spec: ApproxSpec):
    """The integer front end every LUT scheme shares (paper Fig. 3): sign
    strip, |x|, index/t bit-slice, domain-range compare. Returns
    (sign_neg, idx clipped, in_range, t_q raw residue)."""
    tb = spec.t_bits
    sign_neg = vq < 0
    mag = torch.abs(vq)
    idx = mag >> tb
    in_range = idx < spec.depth
    idx_c = torch.clamp(idx, 0, spec.depth - 1)
    t_q = mag & ((1 << tb) - 1)
    return sign_neg, idx_c, in_range, t_q


def _fixed_finish(y, sign_neg, in_range, spec: ApproxSpec):
    """Saturation mux + odd-symmetry sign restore on the lattice."""
    y = torch.where(in_range, y, _sat_q(spec))
    if spec.odd:
        y = torch.where(sign_neg, -y, y)
    return y


def _rom_column(params_q, idx, j: int):
    """Column ``j`` of an int32 ROM at the segment indices ``idx``."""
    return cr.take_rows(params_q[:, j].contiguous(), idx)


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

    def build_fixed(self, spec, target="tanh"):
        # quantized from the float64 knot table, exactly as
        # build_fixed_table does
        ftab = cr.build_fixed_table(_target_fn(target), spec.x_max,
                                    spec.depth, spec.qformat)
        return np.asarray(ftab.windows_q)

    def fixed_block(self, vq, params_q, spec):
        # the authoritative CR integer datapath is
        # catmull_rom.interpolate_fixed (same index geometry:
        # FixedTable.t_bits == spec.t_bits; wide geometries run the limb MAC)
        ftab = cr.FixedTable(spec.qformat, spec.x_max, spec.depth,
                             spec.t_bits, params_q, _sat_q(spec))
        return cr.interpolate_fixed(ftab, vq)

    def requantize(self, params, spec):
        # window values quantized straight to the OUTPUT lattice, as
        # build_fixed_table does to the f64 knot windows
        return quantize(torch.as_tensor(params).to(torch.float32),
                        spec.qformat)


@register
class PWL(Approximant):
    """Piecewise-linear over uniform knots: one LUT row (value, delta)
    per segment and a single multiplier, y = y0 + t * (y1 - y0)
    (PLAN-style, the cheapest point of the design space)."""

    scheme = "pwl"
    hardware = "value+delta LUT, single slope MAC (PLAN-style)"
    default_geometry = {"depth": 32}

    def params_shape(self, spec):
        return (spec.depth, 2)

    def build(self, spec, target="tanh"):
        fn = _target_fn(target)
        ks = np.arange(spec.depth + 1, dtype=np.float64) * spec.period
        y = fn(ks)
        out = np.stack([y[:-1], np.diff(y)], axis=1)
        return np.asarray(out, np.float32)

    def block(self, v, params, spec, *, lookup="take", odd=None):
        odd = spec.odd if odd is None else odd
        av = torch.abs(v) if odd else v
        ki, t = _index_t_split(av, spec)
        y0, dy = _gather_columns(params, ki, lookup)
        return _finish(y0 + t * dy, v, av, spec, odd)

    def build_fixed(self, spec, target="tanh"):
        # knots quantized to the OUTPUT lattice, deltas formed on the
        # lattice so segment ends land exactly on the quantized knots
        fn = _target_fn(target)
        ks = np.arange(spec.depth + 1, dtype=np.float64) * spec.period
        yq = quantize(fn(ks), spec.qformat)
        return np.stack([yq[:-1], np.diff(yq)], axis=1).astype(np.int32)

    def fixed_block(self, vq, params_q, spec):
        # the integer value+delta MAC: y = y0 + (t_q * dy) >>r t_bits, one
        # product with a rounding adder folded into the shift
        sign_neg, idx, in_range, t_q = _fixed_front(vq, spec)
        tb = spec.t_bits
        y0 = _rom_column(params_q, idx, 0)
        dy = _rom_column(params_q, idx, 1)
        # |dy| <= slope * period on the lattice: tb+1 bits covers every
        # target with |f'| <= 1 (tanh family and the softplus residual)
        step = fx_mul_shift(dy, t_q, tb, rounding="nearest",
                            a_bits=tb + 1, b_bits=tb)
        y = sat(y0 + step, spec.qformat)
        return _fixed_finish(y, sign_neg, in_range, spec)

    def requantize(self, params, spec):
        # knots from (value, delta), quantized to the OUTPUT lattice, the
        # deltas re-formed ON the lattice: build_fixed's order of operations
        p = torch.as_tensor(params).to(torch.float32)
        knots = torch.cat([p[:, 0], p[-1:, 0] + p[-1:, 1]])
        yq = quantize(knots, spec.qformat)
        return torch.stack([yq[:-1], yq[1:] - yq[:-1]], dim=1)


@register
class PiecewisePoly(Approximant):
    """Per-segment polynomial in the local coordinate t in [0, 1),
    endpoint-interpolating with interior Chebyshev nodes, evaluated in
    Horner form: a [depth, degree+1] coefficient LUT feeding ``degree``
    MACs. Pinning both segment ends keeps the piecewise function
    continuous, exactly 0 at 0 for odd targets, and monotone over the
    Q2.13 lattice at every swept geometry."""

    scheme = "poly"
    hardware = "coeff LUT + degree-stage Horner MAC chain (DCTIF-style)"
    default_geometry = {"depth": 8, "degree": 3}

    def params_shape(self, spec):
        return (spec.depth, spec.degree + 1)

    def build(self, spec, target="tanh"):
        fn = _target_fn(target)
        deg = spec.degree
        if deg < 1:
            raise ValueError(f"poly needs degree >= 1, got {deg}")
        out = np.empty((spec.depth, deg + 1), np.float64)
        j = np.arange(max(deg - 1, 1), dtype=np.float64)
        tnodes = 0.5 * (1.0 - np.cos((2 * j + 1) * np.pi
                                     / (2 * max(deg - 1, 1))))
        for k in range(spec.depth):
            a = k * spec.period
            fa = float(fn(np.float64(a)))
            fb = float(fn(np.float64(a + spec.period)))
            if deg == 1:                     # endpoint line (PWL-equal)
                out[k] = [fb - fa, fa]
                continue
            ys = fn(a + tnodes * spec.period)
            lin = fa + (fb - fa) * tnodes
            r = np.polyfit(tnodes, (ys - lin) / (tnodes * (1.0 - tnodes)),
                           deg - 2)
            # p = fa + (fb-fa) t + t(1-t) r(t), expanded to power basis
            p = np.polymul(np.atleast_1d(r), [-1.0, 1.0, 0.0])
            base = np.zeros(deg + 1)
            base[-1], base[-2] = fa, fb - fa
            p = np.polyadd(p, base)
            out[k] = np.pad(p, (deg + 1 - len(p), 0))
        return np.asarray(out, np.float32)   # highest power first

    def block(self, v, params, spec, *, lookup="take", odd=None):
        odd = spec.odd if odd is None else odd
        av = torch.abs(v) if odd else v
        ki, t = _index_t_split(av, spec)
        coeffs = _gather_columns(params, ki, lookup)
        y = coeffs[0]
        for c in coeffs[1:]:                 # Horner, highest power first
            y = y * t + c
        return _finish(y, v, av, spec, odd)

    def fixed_block(self, vq, params_q, spec):
        # truncating Horner chain over the guard-bit coefficient ROM: each
        # MAC stage is (acc * t_q) >> t_bits (a wire shift) plus the next
        # ROM coefficient, in the guard format; ONE rounding shift at the
        # end drops the guard bits into the output register
        sign_neg, idx, in_range, t_q = _fixed_front(vq, spec)
        tb = spec.t_bits
        gfmt = spec.guard_format
        acc_bits = spec.int_bits + gfmt.frac_bits + 1
        acc = _rom_column(params_q, idx, 0)
        for j in range(1, spec.degree + 1):
            step = fx_mul_shift(t_q, acc, tb, rounding="floor",
                                a_bits=tb, b_bits=acc_bits)
            acc = sat(step + _rom_column(params_q, idx, j), gfmt)
        y = sat((acc + (1 << (GUARD_BITS - 1))) >> GUARD_BITS, spec.qformat)
        return _fixed_finish(y, sign_neg, in_range, spec)


def _pade_from_cf(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Pade num/den polynomials in u = x^2 from the tanh continued
    fraction  tanh(x) = x / (1 + u/(3 + u/(5 + ...)))  truncated at
    ``order`` levels:  tanh ~= x * num(u) / den(u).  Coefficients are
    float64, lowest power first, NOT yet normalized."""
    # R_k = N_k / D_k with R_order = [2*order - 1]; descend via
    # R_k = (2k-1) + u / R_{k+1} = ((2k-1) N_{k+1} + u D_{k+1}) / N_{k+1}
    n = np.array([2.0 * order - 1.0])
    d = np.array([1.0])
    for k in range(order - 1, 0, -1):
        u_d = np.concatenate([[0.0], d])     # u * D_{k+1}
        width = max(len(n), len(u_d))
        new_n = (2.0 * k - 1.0) * np.pad(n, (0, width - len(n)))
        new_n = new_n + np.pad(u_d, (0, width - len(u_d)))
        n, d = new_n, n
    return d, n                              # tanh ~= x * D_1 / N_1


@register
class PadeRational(Approximant):
    """Pade approximant of tanh with a Newton-iteration reciprocal (no
    divider): a linear equioscillating seed r0 = alpha - beta*den, then
    NEWTON_ITERS steps r <- r * (2 - den * r).

    Only odd continued-fraction orders (the monotone, saturating branch):
    ``degree`` is rounded up to the next odd order >= 3. Params [3, K]:
    row 0 num coeffs (u^0..), row 1 den coeffs, row 2 [alpha, beta, 0...].
    Pade targets tanh only: ``build`` rejects the softplus residual."""

    scheme = "rational"
    hardware = "Pade num/den Horner + seeded Newton reciprocal (no divider)"
    default_geometry = {"degree": 5}

    @staticmethod
    def _order(degree: int) -> int:
        order = max(int(degree), 3)
        return order if order % 2 == 1 else order + 1

    def params_shape(self, spec):
        order = self._order(spec.degree)
        return (3, order // 2 + 1)           # den degree in u = (order-1)/2

    def build(self, spec, target="tanh"):
        if target != "tanh":
            raise ValueError(
                "rational (Pade) approximant targets tanh only; the "
                f"softplus residual {target!r} needs a table-based scheme "
                "(cr_spline / pwl / poly)")
        order = self._order(spec.degree)
        num, den = _pade_from_cf(order)
        num, den = num / den[0], den / den[0]        # den(0) = 1
        k = max(len(num), len(den), 2)
        # equioscillating linear seed for 1/den on [1, D]
        big_d = float(np.polyval(den[::-1], spec.x_max ** 2))
        beta = 8.0 / (4.0 * big_d + (big_d + 1.0) ** 2)
        alpha = beta * (big_d + 1.0)
        out = np.zeros((3, k), np.float64)
        out[0, :len(num)] = num
        out[1, :len(den)] = den
        out[2, :2] = (alpha, beta)
        return np.asarray(out, np.float32)

    def block(self, v, params, spec, *, lookup="take", odd=None):
        del lookup                           # no LUT: pure arithmetic
        odd = spec.odd if odd is None else odd
        av = torch.abs(v) if odd else v
        avc = torch.clamp(av, max=_f32(spec.x_max))   # keep den in range
        u = avc * avc
        k = params.shape[1]
        num = params[0, k - 1]
        den = params[1, k - 1]
        for j in range(k - 2, -1, -1):       # two Horner chains in u
            num = num * u + params[0, j]
            den = den * u + params[1, j]
        num = num * avc
        r = params[2, 0] - params[2, 1] * den    # linear seed for 1/den
        for _ in range(NEWTON_ITERS):
            r = r * (2.0 - den * r)
        # clamp Pade overshoot at the saturation constant: odd CF
        # convergents are increasing, so min() keeps monotonicity
        y = torch.clamp(num * r, max=_f32(spec.saturation))
        return _finish(y, v, av, spec, odd)

    def _internal_int_bits(self, spec) -> int:
        """Integer bits of the chain's internal format: wide enough for
        den(x_max^2), computed host-side from the same continued
        fraction the params bake in."""
        order = self._order(spec.degree)
        num, den = _pade_from_cf(order)
        big_d = float(np.polyval((den / den[0])[::-1], spec.x_max ** 2))
        return max(spec.int_bits, int(np.ceil(np.log2(big_d))) + 1)

    def fixed_block(self, vq, params_q, spec):
        # the integer Pade + Newton-reciprocal chain, in an internal guard
        # format Q<gI>.<frac+GUARD_BITS> whose integer width covers
        # den(x_max^2); each product is one wide MAC with a rounding adder
        # folded into its single output shift, lowered exactly on int32
        # by fx_mul_shift. A ROM entry params_q[i, j] is a 0-d tensor on
        # the ROM's device, never a host number.
        fmt = spec.qformat
        gfmt = spec.guard_format
        gf = gfmt.frac_bits
        ifmt = QFormat(self._internal_int_bits(spec), gf)
        w = ifmt.int_bits + gf + 1           # operand magnitude bound
        sign_neg = vq < 0
        mag = torch.abs(vq)
        xmax_q = int(round(spec.x_max * fmt.scale))
        in_range = mag < xmax_q
        avc = torch.clamp(mag, max=xmax_q)   # keep den in range
        in_b = spec.int_bits + spec.frac_bits + 1
        # u = x^2 straight into the guard format: one squarer, shift
        # 2*frac - (frac+G) = frac - G (needs frac_bits > GUARD_BITS)
        if spec.frac_bits <= GUARD_BITS:
            raise ValueError(
                f"rational fixed datapath needs frac_bits > {GUARD_BITS} "
                f"guard bits, got {spec.qformat}")
        u = fx_mul_shift(avc, avc, spec.frac_bits - GUARD_BITS,
                         rounding="nearest", a_bits=in_b, b_bits=in_b)
        u_bits = 2 * spec.int_bits + gf + 1
        k = params_q.shape[1]
        num = params_q[0, k - 1]
        den = params_q[1, k - 1]
        for j in range(k - 2, -1, -1):       # two Horner chains in u
            num = sat(fx_mul_shift(num, u, gf, rounding="nearest",
                                   a_bits=w, b_bits=u_bits)
                      + params_q[0, j], ifmt)
            den = sat(fx_mul_shift(den, u, gf, rounding="nearest",
                                   a_bits=w, b_bits=u_bits)
                      + params_q[1, j], ifmt)
        # seeded Newton reciprocal: r <- r * (2 - den * r), no divider
        two_g = 2 << gf
        r = sat(params_q[2, 0]
                - fx_mul_shift(params_q[2, 1], den, gf, rounding="nearest",
                               a_bits=gf + 2, b_bits=w), ifmt)
        for _ in range(NEWTON_ITERS):
            dr = fx_mul_shift(den, r, gf, rounding="nearest",
                              a_bits=w, b_bits=w)
            r = sat(fx_mul_shift(r, two_g - dr, gf, rounding="nearest",
                                 a_bits=w, b_bits=w), ifmt)
        ratio = sat(fx_mul_shift(num, r, gf, rounding="nearest",
                                 a_bits=w, b_bits=w), ifmt)
        # final multiplier drops back to the output lattice; clamp the
        # Pade overshoot at the saturation constant (monotone branch)
        y = fx_mul_shift(ratio, avc, gf, rounding="nearest",
                         a_bits=gf + 2, b_bits=in_b)
        y = sat(torch.clamp(y, max=_sat_q(spec)), fmt)
        return _fixed_finish(y, sign_neg, in_range, spec)
