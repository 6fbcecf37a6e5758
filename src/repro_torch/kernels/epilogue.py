"""The approximant-epilogue subsystem: one activation datapath, two
hand-written CUDA kernels.

Counterpart of ``repro/kernels/epilogue.py``. It owns:

  * ``TableSpec`` — an alias of ``approximant.ApproxSpec``;
  * ``_cr_tanh_block`` — the paper's Fig. 2/3 datapath on an f32 tensor
    (index/t split, 4-tap basis MAC, saturation, odd-symmetry sign
    fixup), the single authoritative CR block;
  * the composable epilogues ``tanh | sigmoid | silu | gelu_tanh |
    softplus`` (``make_epilogue``) plus ``table_for`` / ``params_for``;
  * the two kernels every public op instantiates, each beside its plain
    PyTorch version and a launch counter:
      - ``elementwise_2d`` / ``elementwise_2d_plain``: y = epilogue(x);
      - ``glu_2d`` / ``glu_2d_plain``:
        out = epilogue(x @ w_gate) * (x @ w_up) on the f32 accumulators.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches its kernel (``csrc/elementwise.cu``, ``csrc/epilogue.cu``,
built by ``_build``) or raises. There is no other route. A meta tensor
(the dry run, ``launch/dryrun.py``) gets the kernel's meta contract: the
CUDA route's checks, then an empty output of the right shape, no launch.
``elementwise_work`` / ``glu_work`` are each kernel's work (FLOPs from
``csrc/approximant.cuh``, ``epilogue_ops``; the bytes it moves), which a
cost count (``COUNTER``, ``analysis/hlo_cost.py``) takes at the entry in
place of whatever the route runs inside.
``_elementwise_geometry`` sets ``elementwise_2d``'s launch geometry by
shape, ``_glu_f32_geometry`` the f32 ``glu_2d`` kernel's tile and K split.
``LAUNCHES[name]`` counts the kernel's launches and nothing else;
``GLU_VARIANTS`` splits ``glu_2d``'s launches by the variant
``_glu_variant`` chose (TMA + wgmma for bf16, wmma for bf16 operands TMA
cannot address, TMA + cluster FFMA for f32, SIMT for f32 operands TMA
cannot address). Both kernels carry every registered scheme
(``cr_spline``, ``pwl``, ``poly``, ``rational``), chosen per launch.
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from repro_torch.core import approximant
from repro_torch.core import catmull_rom as cr
from repro_torch.core.approximant import ApproxSpec

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)

EPILOGUES = ("tanh", "sigmoid", "silu", "gelu_tanh", "softplus")
LOOKUPS = ("onehot", "take")

TableSpec = ApproxSpec

# kernel launches, counted by each wrapper right after its launch
LAUNCHES = {"elementwise_2d": 0, "glu_2d": 0}
# glu_2d launches by variant (see _glu_variant); they sum to
# LAUNCHES["glu_2d"]
GLU_VARIANTS = {"tma_wgmma": 0, "wmma": 0, "tma_f32": 0, "simt_f32": 0}

_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
_GLU_VARIANT_IDS = {"wmma": 0, "tma_wgmma": 1, "simt_f32": 2,
                    "tma_f32": 3}  # csrc GLU_*
_SCHEME_IDS = {"cr_spline": 0, "pwl": 1, "poly": 2, "rational": 3}
_MAX_PARAMS = 2048    # csrc/approximant.cuh MAX_PARAMS: f32 params in shared memory
_MAX_POLY_DEGREE = 7  # csrc/approximant.cuh MAX_POLY_COLS - 1
_EW_THREADS = 128     # threads of an elementwise_2d block
# tma_f32's tiles (csrc/epilogue.cu F32Decode, F32Rows32, F32Rows64, picked
# by M in launch_glu): (most rows, tile rows, tile columns, K rows a stage,
# CTAs an SM holds (MIN_BLOCKS), whether the K split fills every slot the
# SMs hold or stops at one CTA for each SM); the largest cluster
# (F32_MAX_SPLIT) and the H100 SXM's SMs (SM_COUNT)
_F32_TILES = ((8, 8, 32, 32, 3, False), (32, 32, 64, 16, 3, False),
              (None, 64, 64, 16, 3, True))
_F32_MAX_SPLIT, _SM_COUNT = 8, 132

# f32 operations of each epilogue's wiring around its one tanh unit
# (csrc/approximant.cuh epi_arg + epi_out)
WIRING_OPS = {"tanh": 0, "sigmoid": 3, "silu": 4, "gelu_tanh": 8,
              "softplus": 3}

# the cost counter of a running count (analysis/hlo_cost.py::Counter), or
# None: a kernel's work is counted once, at its entry
COUNTER = None


def epilogue_ops(spec, params, act: str = "silu") -> int:
    """f32 operations of one ``act`` epilogue element under ``spec``,
    counted from csrc/approximant.cuh: the wiring (WIRING_OPS: silu 4),
    |x| 1, saturate and sign 3, and the scheme's block: index split 6 for
    the LUT schemes; cr_spline basis 22 + 4-tap MAC 7; pwl one MAC 2; poly
    Horner 2 per degree; rational clamp + square 2, two Horner chains 4
    per step, x multiply 1, seed 2, Newton 3 per step, product + clamp
    2."""
    rows, cols = params.shape
    block = {"cr_spline": lambda: 6 + 22 + 7,
             "pwl": lambda: 6 + 2,
             "poly": lambda: 6 + 2 * (cols - 1),
             "rational": lambda: 2 + 4 * (cols - 1) + 1 + 2 + 3 * 5 + 2}
    return WIRING_OPS[act] + 1 + 3 + block[spec.scheme]()


def elementwise_work(x, params, spec, act: str) -> tuple[dict, int]:
    """({flop class: FLOPs}, bytes) of one ``elementwise_2d`` launch: the
    epilogue's f32 operations on every element (``"vector"``: CUDA cores,
    whatever x's type), x read and y written once, the params read."""
    n = x.numel()
    return ({"vector": n * epilogue_ops(spec, params, act)},
            2 * n * x.element_size() + params.numel() * 4)


def glu_work(x, w_gate, params, spec, act: str) -> tuple[dict, int]:
    """({flop class: FLOPs}, bytes) of one ``glu_2d`` launch: the two
    products' 2 x 2 x M x K x N in x's type (tensor cores for bf16; f32
    runs SIMT), the epilogue on the M x N gate accumulator; x and both
    weights read, out written once, the params read."""
    (m, k), n = x.shape, w_gate.shape[1]
    return ({str(x.dtype).removeprefix("torch."): 4 * m * k * n,
             "vector": m * n * epilogue_ops(spec, params, act)},
            (m * k + 2 * k * n + m * n) * x.element_size()
            + params.numel() * 4)


def _counted(name: str, work):
    """The running count's record of one launch of kernel ``name`` doing
    ``work`` (a thunk giving ``*_work``'s pair; None: the call launches
    nothing); nothing that runs inside is counted again. A no-op when no
    count runs."""
    c = COUNTER
    if c is None or work is None:
        return contextlib.nullcontext()
    return c.kernel(name, work())


def table_for(act: str, x_max: float, depth: int) -> cr.SplineTable:
    """The spline table an epilogue reads: one shared tanh table for the
    tanh family; softplus has its own even residual table, widened to
    x_max >= 8, depth >= 64."""
    from repro_torch.core.activations import softplus_residual_table, tanh_table
    if act == "softplus":
        return softplus_residual_table(max(x_max, 8.0), max(depth, 64))
    if act in EPILOGUES:
        return tanh_table(x_max, depth)
    raise ValueError(f"unknown epilogue {act!r}")


def _spec_for_epilogue(act: str, scheme: str, x_max: float, depth: int,
                       degree: int = 3) -> ApproxSpec:
    """The spec an epilogue runs under: the cr_spline route goes through
    ``table_for``; other schemes resolve through the registry."""
    if scheme == "cr_spline":
        return TableSpec.of(table_for(act, x_max, depth))
    return approximant.spec_for(scheme, act, x_max=x_max, depth=depth,
                                degree=degree)


def params_for(act: str, spec: ApproxSpec) -> np.ndarray:
    """The flat f32 params array an epilogue reads under ``spec``."""
    return approximant.params_for(spec, approximant.target_of(act))


def _basis_weights_f32(t):
    """CR basis (incl. the 1/2) in f32 Horner form; t in [0, 1)."""
    w0 = 0.5 * (((-t + 2.0) * t - 1.0) * t)
    w1 = 0.5 * ((3.0 * t - 5.0) * t * t + 2.0)
    w2 = 0.5 * (((-3.0 * t + 4.0) * t + 1.0) * t)
    w3 = 0.5 * ((t - 1.0) * t * t)
    return w0, w1, w2, w3


def _cr_tanh_block(v, win, *, spec: TableSpec, lookup: str = "onehot",
                   odd: bool = True):
    """CR-spline interpolation of an f32 tensor — the shared datapath.

    The index/t split is a float multiply by the inverse period and a
    floor (hardware: a bit slice). ``lookup`` "onehot" and "take" select
    the same window values (a one-hot f32 dot selects them exactly), so
    both are one gather here. ``odd=True`` evaluates on |v| and restores
    the sign (tanh family); ``odd=False`` evaluates at v directly
    (softplus residual; the caller supplies a non-negative argument)."""
    if lookup not in LOOKUPS:
        raise ValueError(f"unknown lookup {lookup!r}")
    av = torch.abs(v) if odd else v
    u = av * spec.inv_period
    k = torch.clamp(torch.floor(u), 0.0, spec.depth - 1.0)
    t = u - k                                        # in [0, 1)
    # a NaN input takes window 0 (t, and so y, stay NaN): its integer
    # cast would index out of bounds
    p = cr.table_lookup(win, torch.nan_to_num(k).to(torch.int64))  # [..., 4]
    p0, p1, p2, p3 = p.unbind(-1)
    w0, w1, w2, w3 = _basis_weights_f32(t)
    y = p0 * w0 + p1 * w1 + p2 * w2 + p3 * w3        # the 4-tap MAC
    # the saturation as a Python scalar (rounded to f32 by the op): a
    # tensor made from it on the card is a copy from host memory, which
    # makes the host wait for the device (the train step's recompute
    # backward runs this on the card once a layer)
    y = torch.where(av >= spec.x_max, approximant._f32(spec.saturation), y)
    if odd:
        y = torch.where(v < 0.0, -y, y)              # odd-symmetry fixup
    return y


def _block_for(spec: ApproxSpec, lookup: str):
    """The scheme's tensor datapath ``fn(v, params, odd=...)``."""
    if spec.scheme == "cr_spline":
        return functools.partial(_cr_tanh_block, spec=spec, lookup=lookup)

    def blk(v, params, odd: bool = True):
        return approximant.block(v, params, spec, lookup=lookup, odd=odd)
    return blk


def make_epilogue(act: str, spec: TableSpec, lookup: str = "onehot"):
    """Build the f32 epilogue ``fn(v, params) -> y`` for ``act``; every
    tanh-derived epilogue reuses ONE approximant evaluation per element:
        sigmoid(x) = (1 + tanh(x/2)) / 2
        silu(x)    = x * sigmoid(x)
        gelu_tanh  = x/2 * (1 + tanh(c(x + 0.044715 x^3)))
        softplus   = relu(x) + h(|x|)           (own even residual table)
    """
    block = _block_for(spec, lookup)
    if act == "tanh":
        return lambda v, win: block(v, win)
    if act == "sigmoid":
        return lambda v, win: 0.5 * (1.0 + block(v * 0.5, win))
    if act == "silu":
        return lambda v, win: v * (0.5 * (1.0 + block(v * 0.5, win)))
    if act == "gelu_tanh":
        def gelu(v, win):
            inner = SQRT_2_OVER_PI * (v + 0.044715 * v * v * v)
            return 0.5 * v * (1.0 + block(inner, win))
        return gelu
    if act == "softplus":
        return lambda v, win: torch.relu(v) + block(torch.abs(v), win,
                                                    odd=False)
    raise ValueError(f"unknown epilogue {act!r}")


def _check_params(params, spec: ApproxSpec, act: str):
    """Checks of both wrappers, on every route: the params' shape, and
    the reference's refusal of a rational softplus (Pade targets tanh
    only, so there is no residual to evaluate)."""
    if act == "softplus" and spec.scheme == "rational":
        raise ValueError(
            "rational (Pade) approximant targets tanh only; the softplus "
            "residual 'softplus_res' needs a table-based scheme "
            "(cr_spline / pwl / poly)")
    expected = approximant.get(spec.scheme).params_shape(spec)
    if tuple(params.shape) != tuple(expected):
        raise ValueError(f"params shape {tuple(params.shape)} != "
                         f"{tuple(expected)} for {spec}")


def _route(x) -> str:
    """"cuda": launch the kernel; "cpu": run the plain version; "meta":
    the kernel's meta contract (its checks, an empty output). The device
    of the input decides, nothing else."""
    if x.device.type in ("cuda", "cpu", "meta"):
        return x.device.type
    raise ValueError(f"no epilogue kernel for device {x.device}")


def _kernel_args(act: str, spec: ApproxSpec, params, x):
    """Checks shared by both wrappers; returns the C call's trailing
    (scheme, params rows, params cols, epi, dtype, inv_period, x_max,
    saturation). The params' rows are the LUT depth of cr_spline / pwl /
    poly and 3 for rational, which reads no depth."""
    if spec.scheme not in _SCHEME_IDS:
        raise ValueError(f"scheme {spec.scheme!r} has no kernel datapath; "
                         f"the kernels carry {sorted(_SCHEME_IDS)}")
    if act not in EPILOGUES:
        raise ValueError(f"unknown epilogue {act!r}")
    if x.dtype not in _DTYPE_IDS:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    if (params.device != x.device or params.dtype != torch.float32
            or not params.is_contiguous()):
        raise ValueError("params must be a contiguous float32 tensor on "
                         f"{x.device}")
    rows, cols = params.shape
    if rows * cols > _MAX_PARAMS:
        raise ValueError(f"params {tuple(params.shape)} exceed the kernel's "
                         f"shared-memory limit of {_MAX_PARAMS} floats")
    if spec.scheme == "poly" and cols - 1 > _MAX_POLY_DEGREE:
        raise ValueError(f"poly degree {cols - 1} > kernel limit "
                         f"{_MAX_POLY_DEGREE}")
    return (_SCHEME_IDS[spec.scheme], rows, cols, EPILOGUES.index(act),
            _DTYPE_IDS[x.dtype], spec.inv_period, spec.x_max,
            spec.saturation)


def _raw_stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``, the one the
    kernel launches on. Read through the call Triton's launcher uses:
    ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
    and costs several microseconds of host time per launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# kernel 1: matmul-free epilogue
# ---------------------------------------------------------------------------

def elementwise_2d_plain(x, params, *, spec: TableSpec, act: str = "tanh",
                         lookup: str = "onehot"):
    """Plain PyTorch version of ``elementwise_2d``: f32 math, result cast
    back to x's dtype."""
    epi = make_epilogue(act, spec, lookup)
    return epi(x.to(torch.float32), params.to(torch.float32)).to(x.dtype)


def _elementwise_geometry(rows: int, cols: int, dtype,
                          aligned: bool = True) -> tuple[int, int, int]:
    """(blocks, threads, elems_per_thread) of one ``elementwise_2d`` launch
    over a contiguous [rows, cols] array. Thread g takes elements
    [g * ept, g * ept + ept) below n = rows * cols, and blocks * threads *
    ept covers n with no block past it (the C side refuses anything else,
    and the wrapper raises).

    ept is one 16-byte vector (8 bf16, 4 f32) and a block has 128 threads,
    at every shape: [2, 3072] bf16 (decode) is 6 blocks, [128, 3072] 384.
    Spreading decode over 48 blocks of 2-element threads measured slower
    on the card (see csrc/elementwise.cu). ``aligned`` (x and y 16-byte
    aligned) does not change the geometry, so the wrapper does not pass
    it: the kernel reads a misaligned array's vectors element by
    element."""
    if dtype not in _DTYPE_IDS:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    del aligned
    ept = 16 // dtype.itemsize
    return max(1, -(-(rows * cols) // (_EW_THREADS * ept))), _EW_THREADS, ept


def elementwise_2d(x, params, *, spec: TableSpec, act: str = "tanh",
                   lookup: str = "onehot"):
    """Apply one approximant epilogue to a 2D tensor in ONE kernel launch
    (CUDA), or through the plain version (CPU). Any [rows, cols] shape:
    the kernel masks its own ragged edge."""
    if x.dim() != 2:
        raise ValueError(f"elementwise_2d takes a 2D tensor, got {x.shape}")
    _check_params(params, spec, act)
    work = (lambda: elementwise_work(x, params, spec, act)) \
        if x.numel() else None
    with _counted("elementwise_2d", work):
        return _elementwise_2d(x, params, spec, act, lookup)


def _elementwise_2d(x, params, spec, act, lookup):
    route = _route(x)
    if route == "cpu":
        return elementwise_2d_plain(x, params, spec=spec, act=act,
                                    lookup=lookup)
    args = _kernel_args(act, spec, params, x)
    y = torch.empty_like(x)
    rows, cols = x.shape
    if rows * cols == 0 or route == "meta":
        return y
    from . import _build
    geometry = _elementwise_geometry(rows, cols, x.dtype)
    rc = _build.library().repro_elementwise_2d(
        x.data_ptr(), params.data_ptr(), y.data_ptr(), rows, cols, *args,
        *geometry, _raw_stream(x.device))
    _raise_on(rc, f"elementwise_2d {geometry}")
    LAUNCHES["elementwise_2d"] += 1
    return y


# ---------------------------------------------------------------------------
# kernel 2: GLU epilogue (fused matmuls + epilogue on the f32 accumulator)
# ---------------------------------------------------------------------------

def glu_2d_plain(x, w_gate, w_up, params, *, spec: TableSpec,
                 act: str = "silu", lookup: str = "onehot"):
    """Plain PyTorch version of ``glu_2d``: f32 matmuls of the upcast
    inputs, then the same epilogue, cast once to x's dtype."""
    epi = make_epilogue(act, spec, lookup)
    xf = x.to(torch.float32)
    gate = xf @ w_gate.to(torch.float32)
    up = xf @ w_up.to(torch.float32)
    return (epi(gate, params.to(torch.float32)) * up).to(x.dtype)


def _glu_variant(m: int, n: int, k: int, dtype, aligned: bool) -> str:
    """Which ``glu_2d`` kernel a CUDA launch takes, by operand shape, type
    and alignment (not a fallback: the C side refuses a variant that does
    not fit, and the wrapper raises):

      "tma_wgmma"  bf16 that TMA can address: x, w_gate and w_up 16-byte
                   aligned (``aligned``) and both row strides multiples of
                   16 bytes (K % 8 == 0 for x, N % 8 == 0 for the weights);
      "wmma"       bf16 operands TMA cannot address;
      "tma_f32"    float32 that TMA can address: the same alignment, K % 4
                   == 0 and N % 4 == 0 (IEEE f32 FMAs, no TF32);
      "simt_f32"   float32 operands TMA cannot address (the same
                   arithmetic, no pipelining).

    ``m`` does not decide the variant; the TMA kernels pick their tile for
    it. The output is allocated by the wrapper, always aligned."""
    if dtype == torch.float32:
        return "tma_f32" if aligned and n % 4 == 0 and k % 4 == 0 \
            else "simt_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"glu_2d kernel takes float32 or bfloat16, got {dtype}")
    if aligned and n % 8 == 0 and k % 8 == 0:
        return "tma_wgmma"
    return "wmma"


def _glu_f32_geometry(m: int, n: int, k: int) -> tuple[int, int, int, int,
                                                       int, int]:
    """(tile rows, tile columns, K rows a block, N tiles, M tiles, split)
    of one ``tma_f32`` launch: the tile csrc/epilogue.cu picks for ``m``
    (``_F32_TILES``), and the cluster of ``split`` CTAs that share each
    tile's kb K blocks; rank r of a cluster takes blocks [r * kb // split,
    (r + 1) * kb // split).

    The split doubles, up to a portable cluster of 8, while the CTAs stay
    under the tile's target, every rank keeps at least one K block, and
    all CTAs still fit on the card at once (``blocks`` an SM). The target
    is one CTA for each SM for the tiles bound by bytes (decode, up to 32
    rows: 172-192 CTAs at the decode shapes; more ranks cost more than
    they stream, measured on an H100) and every slot the SMs hold for the
    64-row tile, bound by FFMAs (a third CTA on an SM hides the latency
    of the others' loads). The C side refuses a split past 8 or past the
    K blocks, and the wrapper raises."""
    bm, bn, bk, blocks, fill = next(t[1:] for t in _F32_TILES
                                    if t[0] is None or m <= t[0])
    slots = blocks * _SM_COUNT
    target = slots if fill else _SM_COUNT
    n_tiles, m_tiles = -(-n // bn), -(-m // bm)
    tiles, kb = n_tiles * m_tiles, -(-k // bk)
    split = 1
    while (split < _F32_MAX_SPLIT and tiles * split < target
           and kb >= 2 * split and tiles * 2 * split <= slots):
        split *= 2
    return bm, bn, bk, n_tiles, m_tiles, split


def glu_2d(x, w_gate, w_up, params, *, spec: TableSpec, act: str = "silu",
           lookup: str = "onehot"):
    """out[M,N] = epilogue(x[M,K] @ w_gate[K,N]) * (x @ w_up) in ONE
    kernel launch (CUDA), or through the plain version (CPU): the gate
    projection never round-trips to device memory and is never rounded
    below f32 before the epilogue."""
    if x.dim() != 2 or w_gate.dim() != 2:
        raise ValueError(f"glu_2d takes 2D operands, got {x.shape}, "
                         f"{w_gate.shape}")
    m, k = x.shape
    k2, n = w_gate.shape
    if k != k2 or tuple(w_up.shape) != (k, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}")
    _check_params(params, spec, act)
    work = (lambda: glu_work(x, w_gate, params, spec, act)) \
        if m * n * k else None
    with _counted("glu_2d", work):
        return _glu_2d(x, w_gate, w_up, params, spec, act, lookup)


def _glu_2d(x, w_gate, w_up, params, spec, act, lookup):
    route = _route(x)
    if route == "cpu":
        return glu_2d_plain(x, w_gate, w_up, params, spec=spec, act=act,
                            lookup=lookup)
    args = _kernel_args(act, spec, params, x)
    for w in (w_gate, w_up):
        if w.device != x.device or w.dtype != x.dtype or not w.is_contiguous():
            raise ValueError(f"weights must be contiguous {x.dtype} on "
                             f"{x.device}")
    (m, k), n = x.shape, w_gate.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("glu_2d needs K >= 1")
    if route == "meta":
        return out
    from . import _build
    ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr())
    variant = _glu_variant(m, n, k, x.dtype, all(a % 16 == 0 for a in ptrs))
    split = _glu_f32_geometry(m, n, k)[-1] if variant == "tma_f32" else 0
    rc = _build.library().repro_glu_2d(
        *ptrs, params.data_ptr(), out.data_ptr(), m, n, k, *args,
        _GLU_VARIANT_IDS[variant], split, _raw_stream(x.device))
    _raise_on(rc, f"glu_2d ({variant})")
    LAUNCHES["glu_2d"] += 1
    GLU_VARIANTS[variant] += 1
    return out
