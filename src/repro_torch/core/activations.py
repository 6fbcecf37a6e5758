"""Activation engine: every element-wise nonlinearity is routed through
here, selected by config.

Counterpart of ``repro/core/activations.py``. Backends:

  exact     torch reference (what a float accelerator computes)
  cr        Catmull-Rom spline interpolation (the paper, float datapath;
            alias of the registered ``cr_spline`` approximant scheme)
  cr_fixed  bit-accurate Q2.13 emulation of the paper's Fig. 3 circuit,
            with a straight-through float-spline gradient so training works
  pwl       piecewise-linear over the same knots (paper's baseline; also
            a registered approximant scheme)
  poly      piecewise near-minimax polynomial, Horner datapath
            (approximant scheme; degree = ActivationConfig.degree)
  rational  Pade + Newton-reciprocal datapath, no divider
            (approximant scheme; CF order = ActivationConfig.degree)
  region    Zamanlooy-style three-region approximation [6]
  taylor    Adnan-style truncated Taylor series [8]
  base2     Gomar-style base-2 exponential approximation [9]

With ``use_kernel=True`` every nonlinearity of an approximant engine
(cr, pwl, poly, rational) runs as ONE launch of the hand-written
``elementwise_2d`` CUDA kernel (``kernels/epilogue.py``) on a CUDA
tensor, and as that kernel's plain version on a CPU tensor.

``<scheme>_fixed`` (pwl_fixed, poly_fixed, rational_fixed, and
cr_spline_fixed, which ``cr_fixed`` aliases) runs the scheme's
bit-accurate integer datapath (``approximant.fixed_block``) as int32
tensor ops on the input's device; it has no kernel, so ``use_kernel=True``
is refused. Its gradient is straight-through (``_StraightThrough``): the
derivative of the scheme's float block, in x and, on a bound engine, in
the params.

Functions: tanh, sigmoid, silu, gelu_tanh, softplus, derived from the
tanh unit via the paper's identities:
    sigmoid(x) = (1 + tanh(x/2)) / 2
    silu(x)    = x * sigmoid(x)
    softplus(x)= relu(x) + h(|x|),  h(u) = log(1 + e^{-u})  (own even table)
    gelu_tanh(x) = x/2 * (1 + tanh(c*(x + 0.044715 x^3)))
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache, partial

import numpy as np
import torch
import torch.nn.functional as F

from . import approximant
from . import catmull_rom as cr
from .fixed_point import Q2_13, QFormat, dequantize, quantize

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@lru_cache(maxsize=None)
def _const_in(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``: jnp rounds a Python scalar to the
    array's dtype before the op, torch keeps it in the op's f32 math on
    bf16/f16 tensors. A host tensor, so no device is touched."""
    return torch.tensor(c, dtype=dtype).item()


def scheme_of(impl: str) -> str | None:
    """The registered approximant scheme behind an engine impl (None for
    non-approximant backends)."""
    if impl == "cr":
        return "cr_spline"
    return impl if impl in approximant.schemes() else None


def fixed_scheme_of(impl: str) -> str | None:
    """The registered scheme behind a ``<scheme>_fixed`` engine impl
    (``cr_fixed`` is the historical alias of ``cr_spline_fixed``)."""
    if impl == "cr_fixed":
        return "cr_spline"
    if impl.endswith("_fixed"):
        base = scheme_of(impl[: -len("_fixed")])
        if base is not None:
            return base
    return None


@dataclasses.dataclass(frozen=True)
class ActivationConfig:
    """How the framework computes nonlinearities (a model-config field)."""

    impl: str = "exact"          # exact|cr|cr_fixed|pwl|poly|rational|
                                 # region|taylor|base2, any registered
                                 # approximant scheme name, or any
                                 # "<scheme>_fixed" integer datapath
    depth: int = 32              # LUT depth (paper's flagship: 32)
    x_max: float = 4.0           # table range for tanh (paper: 4.0)
    degree: int = 3              # poly: per-segment degree; rational:
                                 # continued-fraction order
    taylor_terms: int = 3        # for impl="taylor"
    use_kernel: bool = False     # approximant impls: route EVERY
                                 # nonlinearity through one launch of the
                                 # elementwise epilogue kernel
    int_bits: int = 2            # Q-format of the *_fixed datapaths
    frac_bits: int = 13          # (the paper's flagship: Q2.13)

    def tag(self) -> str:
        q = "" if (self.int_bits, self.frac_bits) == (2, 13) else \
            f"-q{self.int_bits}.{self.frac_bits}"
        if self.impl in ("poly", "rational"):
            return f"{self.impl}-d{self.depth}-g{self.degree}{q}"
        return f"{self.impl}-d{self.depth}{q}"

    @classmethod
    def from_tag(cls, tag: str, **overrides) -> "ActivationConfig":
        """Parse a ``tag()`` string back into a config. x_max is not
        encoded in tags — pass it via ``overrides`` when non-default."""
        parts = tag.split("-")
        kw: dict = {"impl": parts[0]}
        for p in parts[1:]:
            if p[:1] == "d" and p[1:].isdigit():
                kw["depth"] = int(p[1:])
            elif p[:1] == "g" and p[1:].isdigit():
                kw["degree"] = int(p[1:])
            elif p[:1] == "q" and "." in p:
                ib, fb = p[1:].split(".", 1)
                kw["int_bits"], kw["frac_bits"] = int(ib), int(fb)
            else:
                raise ValueError(f"unparseable activation tag part {p!r} "
                                 f"in {tag!r}")
        kw.update(overrides)
        return cls(**kw)


def tanh_spec_of(cfg: ActivationConfig) -> approximant.ApproxSpec | None:
    """The tanh ApproxSpec whose params are this config's trainable leaf
    (None for non-approximant backends)."""
    scheme = scheme_of(cfg.impl) or fixed_scheme_of(cfg.impl)
    if scheme is None:
        return None
    return approximant.spec_for(scheme, "tanh", x_max=cfg.x_max,
                                depth=cfg.depth, degree=cfg.degree,
                                int_bits=cfg.int_bits,
                                frac_bits=cfg.frac_bits)


def init_act_params(layer_cfgs) -> dict[str, np.ndarray]:
    """tag -> built f32 tanh params for every distinct approximant config
    in a per-layer assignment — the ``params["act"]`` subtree."""
    out: dict[str, np.ndarray] = {}
    for c in layer_cfgs:
        spec = tanh_spec_of(c)
        if spec is not None and c.tag() not in out:
            out[c.tag()] = np.asarray(approximant.params_for(spec, "tanh"),
                                      np.float32)
    return out


@lru_cache(maxsize=None)
def tanh_table(x_max: float, depth: int) -> cr.SplineTable:
    return cr.build_table(np.tanh, x_max, depth, saturation=float(np.tanh(x_max)))


@lru_cache(maxsize=None)
def tanh_fixed_table(x_max: float, depth: int,
                     fmt: QFormat = Q2_13) -> cr.FixedTable:
    return cr.build_fixed_table(np.tanh, x_max, depth, fmt)


@lru_cache(maxsize=None)
def softplus_residual_table(x_max: float, depth: int) -> cr.SplineTable:
    # h(u) = log(1 + e^-u) on [0, x_max); the k=-1 boundary knot uses the
    # natural analytic extension h(-p) = log(1+e^p), not a reflection.
    fn = lambda u: np.log1p(np.exp(-u))
    return cr.build_table(fn, x_max, depth, saturation=float(np.log1p(np.exp(-x_max))))


def _kernel_act(name: str, x, cfg: ActivationConfig, params=None):
    """One-launch dispatch: the whole epilogue runs inside the kernel.
    ``params`` (the model's f32 tanh leaf) overrides the registry-built
    tanh params; the softplus epilogue reads its own residual table."""
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import ops as kernel_ops
    scheme = scheme_of(cfg.impl)
    if name == "softplus":
        params = None
    if scheme == "cr_spline":
        return kernel_ops.act(x, name,
                              table=epi.table_for(name, cfg.x_max, cfg.depth),
                              params=params)
    return kernel_ops.act(x, name, method=scheme, depth=cfg.depth,
                          x_max=cfg.x_max, degree=cfg.degree, params=params)


def _approx_spec(cfg: ActivationConfig, act: str) -> approximant.ApproxSpec:
    return approximant.spec_for(scheme_of(cfg.impl), act, x_max=cfg.x_max,
                                depth=cfg.depth, degree=cfg.degree)


def _tanh_cr(x, cfg: ActivationConfig):
    if cfg.use_kernel:
        return _kernel_act("tanh", x, cfg)
    return cr.interpolate(tanh_table(cfg.x_max, cfg.depth), x)


def _tanh_pwl(x, cfg: ActivationConfig):
    # the reference's unbound pwl engine interpolates the CR tanh table's
    # knots, not the PWL scheme's own [depth, 2] params
    if cfg.use_kernel:
        return _kernel_act("tanh", x, cfg)
    return cr.interpolate_pwl(tanh_table(cfg.x_max, cfg.depth), x)


def _tanh_scheme(x, cfg: ActivationConfig):
    """Generic approximant backend (poly / rational / future schemes):
    the scheme's own block, the datapath the kernel runs."""
    if cfg.use_kernel:
        return _kernel_act("tanh", x, cfg)
    return approximant.reference(x, _approx_spec(cfg, "tanh"))


class _StraightThrough(torch.autograd.Function):
    """y = ``fixed_fn(x, p)``, the bit-accurate integer datapath; the
    gradient is that of ``float_fn(x, p)``, the scheme's float block, in
    x and in ``p`` where ``p`` needs one (the reference's straight-through
    ``custom_jvp``). ``p`` is None on the unbound engines. The backward
    recomputes the float block under autograd."""

    @staticmethod
    def forward(ctx, x, p, fixed_fn, float_fn):
        ctx.save_for_backward(x, p)
        ctx.float_fn = float_fn
        return fixed_fn(x, p)

    @staticmethod
    def backward(ctx, g):
        x, p = ctx.saved_tensors
        want_p = p is not None and ctx.needs_input_grad[1]
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            pd = p.detach().requires_grad_() if want_p else p
            y = ctx.float_fn(xd, pd)
            grads = torch.autograd.grad(y, (xd, pd) if want_p else (xd,), g)
        return grads[0], (grads[1] if want_p else None), None, None


def _fixed_tanh(fmt: QFormat, datapath):
    """x -> dequantize(datapath(quantize(x))) in x's dtype: the input is
    rounded to the Q lattice in f32, the output read back from it."""
    def run(x, p):
        yq = datapath(quantize(x.to(torch.float32), fmt), p)
        return dequantize(yq, fmt).to(x.dtype)
    return run


def _make_tanh_scheme_fixed(cfg: ActivationConfig):
    """Generic ``<scheme>_fixed`` backend: the scheme's integer datapath at
    the config's Q format, reading the registry ROM (copied to the
    input's device once), with a straight-through gradient through the
    scheme's float block."""
    spec = tanh_spec_of(cfg)
    fixed = _fixed_tanh(spec.qformat, lambda xq, _: approximant.fixed_block(
        xq, approximant.fixed_params_on(spec, "tanh", xq.device), spec))
    ref = lambda v, _: approximant.reference(v, spec)
    return lambda x: _StraightThrough.apply(x, None, fixed, ref)


def _make_tanh_fixed_bound(cfg: ActivationConfig, act_params):
    """Bound ``<scheme>_fixed`` backend (quantization-aware): the integer
    ROM is requantized from the bound f32 params on every call, on their
    device, and the straight-through gradient reaches both x and the
    params. ``cr_fixed`` routes here too (its scheme's ``fixed_block`` is
    ``catmull_rom.interpolate_fixed``)."""
    spec = tanh_spec_of(cfg)
    fixed = _fixed_tanh(spec.qformat, lambda xq, q: approximant.fixed_block(
        xq, approximant.requantize(q, spec), spec))
    ref = lambda v, q: approximant.block(v.to(torch.float32), q,
                                         spec).to(v.dtype)
    return lambda x: _StraightThrough.apply(x, act_params, fixed, ref)


def _make_tanh_cr_fixed(cfg: ActivationConfig):
    """``cr_fixed``'s pinned route: ``interpolate_fixed`` on the Fig. 3
    table at the config's Q format, its windows the registry ROM on the
    input's device (``fixed_params_on``: the same ``build_fixed_table``
    windows), straight-through gradient of the float spline in x's
    dtype."""
    spec = tanh_spec_of(cfg)
    ftab = tanh_fixed_table(cfg.x_max, cfg.depth, spec.qformat)
    table = tanh_table(cfg.x_max, cfg.depth)
    fixed = _fixed_tanh(spec.qformat, lambda xq, _: cr.interpolate_fixed(
        ftab._replace(windows_q=approximant.fixed_params_on(
            spec, "tanh", xq.device)), xq))
    ref = lambda v, _: cr.interpolate(table, v)
    return lambda x: _StraightThrough.apply(x, None, fixed, ref)


def _tanh_region(x, cfg: ActivationConfig):
    """Three-region approximation in the spirit of [6] (Zamanlooy): pass
    region |x| < 0.25: y = x; saturation |x| > 3: y = sign(x); processing
    region: PWL over an 8-entry table quantized to 6 fractional bits."""
    tab = tanh_table(3.0, 8)
    ax = torch.abs(x)
    proc = cr.interpolate_pwl(tab, ax, odd=False)
    proc = torch.round(proc * 64.0) / 64.0  # 6-bit output quantization
    y = torch.where(ax < 0.25, ax,
                    torch.where(ax > 3.0, torch.ones_like(ax), proc))
    return torch.sign(x) * y


def _tanh_taylor(x, cfg: ActivationConfig):
    """Truncated odd Taylor series x - x^3/3 + 2x^5/15 - 17x^7/315 [8],
    clamped to +-1."""
    coeffs = [1.0, -1.0 / 3.0, 2.0 / 15.0, -17.0 / 315.0][: cfg.taylor_terms]
    x2 = x * x
    acc = torch.zeros_like(x)
    for c in reversed(coeffs):
        acc = acc * x2 + c
    return torch.clamp(acc * x, -1.0, 1.0)


def _tanh_base2(x, cfg: ActivationConfig):
    """Gomar-style [9]: tanh(x) = (2^{ax} - 2^{-ax}) / (2^{ax} + 2^{-ax})
    with a = 2/ln(2), the exponent path quantized to 5 fractional bits."""
    a = 2.0 / math.log(2.0)
    e = a * x / 2.0
    e = torch.round(e * 32.0) / 32.0   # coarse exponent path
    p = torch.exp2(e)
    n = torch.exp2(-e)
    return (p - n) / (p + n)


_TANH_BACKENDS = {
    "exact": lambda x, cfg: torch.tanh(x),
    "cr": _tanh_cr,
    "cr_spline": _tanh_cr,
    "pwl": _tanh_pwl,
    "poly": _tanh_scheme,
    "rational": _tanh_scheme,
    "region": _tanh_region,
    "taylor": _tanh_taylor,
    "base2": _tanh_base2,
}


class ActivationEngine:
    """Configured set of nonlinearities. Use as:
    ``act = ActivationEngine(cfg); act.silu(x)``."""

    def __init__(self, cfg: ActivationConfig | None = None, act_params=None):
        self.cfg = cfg or ActivationConfig()
        self.act_impl = scheme_of(self.cfg.impl)
        # tanh params bound from the model's params["act"] (see ``bind``);
        # None means the cached registry build
        self.act_params = None if act_params is None else \
            torch.as_tensor(act_params, dtype=torch.float32)
        if fixed_scheme_of(self.cfg.impl) is not None and self.cfg.use_kernel:
            raise ValueError(
                f"impl={self.cfg.impl!r} is a bit-accurate integer "
                f"datapath with no kernel lowering; drop use_kernel=True, "
                f"or use impl={fixed_scheme_of(self.cfg.impl)!r} for the "
                f"f32 kernel path")
        if self.act_params is not None:
            self._tanh = self._bound_tanh()
        elif self.cfg.impl == "cr_fixed":
            self._tanh = _make_tanh_cr_fixed(self.cfg)
        elif fixed_scheme_of(self.cfg.impl) is not None:
            self._tanh = _make_tanh_scheme_fixed(self.cfg)
        else:
            backend = _TANH_BACKENDS.get(self.cfg.impl)
            if backend is None and self.act_impl is not None:
                backend = _tanh_scheme   # any newly registered scheme
            if backend is None:
                raise ValueError(
                    f"unknown activation impl {self.cfg.impl!r}; built-ins: "
                    f"{sorted(_TANH_BACKENDS)} + 'cr_fixed', registered "
                    f"approximant schemes: {list(approximant.schemes())} "
                    f"(each also available as '<scheme>_fixed')")
            self._tanh = partial(backend, cfg=self.cfg)

    def _bound_tanh(self):
        """tanh backend reading ``self.act_params`` instead of the cached
        registry build."""
        cfg, p = self.cfg, self.act_params
        if fixed_scheme_of(cfg.impl) is not None:
            return _make_tanh_fixed_bound(cfg, p)
        if cfg.use_kernel:
            return lambda x: _kernel_act("tanh", x, cfg, params=p)
        if self.act_impl == "cr_spline":
            # same float-spline codepath as the unbound engine, windows
            # swapped for the bound leaf (interpolate casts them to x.dtype)
            tab = tanh_table(cfg.x_max, cfg.depth)._replace(windows=p)
            return lambda x: cr.interpolate(tab, x)
        spec = _approx_spec(cfg, "tanh")
        return lambda x: approximant.block(x.to(torch.float32), p,
                                           spec).to(x.dtype)

    def bind(self, act_params) -> "ActivationEngine":
        """Engine whose tanh params come from the model's
        ``params["act"]`` subtree keyed by ``cfg.tag()``. Returns
        ``self`` when the subtree has no entry for this config."""
        p = (act_params or {}).get(self.cfg.tag())
        if p is None or tanh_spec_of(self.cfg) is None:
            return self
        return ActivationEngine(self.cfg, act_params=p)

    @property
    def _kernelized(self) -> bool:
        """True when every nonlinearity lowers to ONE epilogue kernel."""
        return self.act_impl is not None and self.cfg.use_kernel

    def tanh(self, x):
        return self._tanh(x)

    def sigmoid(self, x):
        if self.cfg.impl == "exact":
            return torch.sigmoid(x)
        if self._kernelized:
            return _kernel_act("sigmoid", x, self.cfg, params=self.act_params)
        return 0.5 * (1.0 + self.tanh(x * 0.5))

    def silu(self, x):
        if self.cfg.impl == "exact":
            return F.silu(x)
        if self._kernelized:
            return _kernel_act("silu", x, self.cfg, params=self.act_params)
        return x * self.sigmoid(x)

    def gelu_tanh(self, x):
        if self.cfg.impl == "exact":
            return F.gelu(x, approximate="tanh")
        if self._kernelized:
            return _kernel_act("gelu_tanh", x, self.cfg,
                               params=self.act_params)
        c1 = _const_in(SQRT_2_OVER_PI, x.dtype)
        c3 = _const_in(0.044715, x.dtype)
        inner = c1 * (x + c3 * (x * x * x))
        return 0.5 * x * (1.0 + self.tanh(inner))

    def softplus(self, x):
        if self.cfg.impl == "exact":
            return F.softplus(x)
        if self._kernelized:
            return _kernel_act("softplus", x, self.cfg)
        if self.act_impl not in (None, "cr_spline"):
            # scheme-consistent residual (the rational scheme rejects the
            # non-tanh target with a clear error at build time)
            spec = _approx_spec(self.cfg, "softplus")
            h = approximant.reference(torch.abs(x), spec, "softplus_res")
            return torch.relu(x) + h
        tab = softplus_residual_table(max(self.cfg.x_max, 8.0),
                                      max(self.cfg.depth, 64))
        h = cr.interpolate(tab, torch.abs(x), odd=False)
        return torch.relu(x) + h

    def __call__(self, name: str, x):
        return getattr(self, name)(x)


class LayerEngines:
    """Per-layer activation engines: the mixed-scheme assignment.

    One ``ActivationEngine`` per DISTINCT config; ``engines[i]`` is layer
    i's. ``segments`` lists the maximal runs of adjacent layers sharing
    an engine as (start, stop, engine): the reference scans each run as
    one ``lax.scan``, the port's stack runners loop over layers and take
    ``engines[i]`` for layer i, which is the same assignment."""

    def __init__(self, cfgs):
        cfgs = tuple(cfgs)
        if not cfgs:
            raise ValueError("LayerEngines needs at least one layer config")
        by_cfg: dict[ActivationConfig, ActivationEngine] = {}
        for c in cfgs:
            if c not in by_cfg:
                by_cfg[c] = ActivationEngine(c)
        self.cfgs = cfgs
        self.engines = tuple(by_cfg[c] for c in cfgs)
        self.segments = self._segments(self.engines)

    @staticmethod
    def _segments(engines):
        segs, start = [], 0
        for i in range(1, len(engines) + 1):
            if i == len(engines) or engines[i] is not engines[start]:
                segs.append((start, i, engines[start]))
                start = i
        return tuple(segs)

    @property
    def distinct(self) -> tuple[ActivationEngine, ...]:
        out: list[ActivationEngine] = []
        for e in self.engines:
            if all(e is not o for o in out):
                out.append(e)
        return tuple(out)

    def bind(self, act_params) -> "LayerEngines":
        """Per-layer analogue of ``ActivationEngine.bind``: every distinct
        engine binds its own ``params["act"]`` leaf (keyed by its
        config's ``tag()``)."""
        if not act_params:
            return self
        bound = {id(e): e.bind(act_params) for e in self.distinct}
        if all(bound[id(e)] is e for e in self.distinct):
            return self
        new = object.__new__(LayerEngines)
        new.cfgs = self.cfgs
        new.engines = tuple(bound[id(e)] for e in self.engines)
        new.segments = self._segments(new.engines)
        return new


def engine_of_layer(engine, i: int) -> ActivationEngine:
    """Layer i's engine: ``engine`` itself for a uniform assignment, its
    i-th entry for a ``LayerEngines``."""
    engines = getattr(engine, "engines", None)
    return engine if engines is None else engines[i]


def get_engine(cfg: ActivationConfig | dict | None = None) -> ActivationEngine:
    if isinstance(cfg, dict):
        cfg = ActivationConfig(**cfg)
    return ActivationEngine(cfg)
