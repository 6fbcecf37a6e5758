#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100), ``nvcc`` and PyTorch built for
CUDA. It imports nothing of JAX and nothing of the JAX package. Both
kernels carry four approximant schemes (``cr_spline``, ``pwl``, ``poly``,
``rational``); every phase runs each scheme. Phases, each printing JSON
lines:

  1. build: compile both hand-written kernels from src/repro_torch/csrc
     with nvcc; print the card's name and power limit; TF32 off.
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at stated tolerances, for every scheme and epilogue at the
     deployment geometry (depth 32, degree 3), and at every float
     geometry ``benchmarks/dse.py`` sweeps. ``glu_2d``'s TMA + wgmma
     variant at M = 1, 2, 64, 65, 128, 256, 512, 1000 and 1024 (K=1024,
     N=3072; above 256 rows the grid loops over 256-row M tiles) and at a
     ragged K=1000, N=3000, and its wmma variant at N=3001, for every
     scheme and epilogue: each case asserts the variant it took and that
     a repeated launch gives the same bits. Then gradients through both
     kernels (``ops.act`` / ``ops.fused_glu``: the kernel forward, the
     plain recompute backward) for every scheme at f32 and bf16, at the
     training row count (1024) and a ragged 1000: bitwise equal to
     autograd through the plain version. Then each scheme's kernel tanh
     over the whole 2^16-point Q2.13 input grid, within 0.03 of tanh.
     Then the bit-accurate integer datapaths, which have no kernel (int32
     tensor ops on the card): ``fixed_grid``, each scheme's
     ``fixed_block`` at its fixed geometry (and CR at depths 8, 16, 64)
     over the whole Q2.13, Q2.10 and Q2.16 lattice from a ROM on the
     card, bit-identical to the CPU, with ``tanh_error(...,
     datapath="fixed")`` per scheme (CR at depth 64 one Q2.13 LSB) and
     ``table_1_2("qout")`` beside the paper's; ``fixed_engine``, every
     nonlinearity of each ``*_fixed`` engine on [1024, 3072] f32 and bf16
     inputs with NaN and ±inf, card = CPU bitwise (softplus, a float
     spline under every impl, within 1e-6 / one bf16 ulp), and the
     straight-through gradients in x (1e-6) and in the act leaf (1e-5).
  3. serve qwen3-0.6b at full width (28 layers, random weights from seed
     0, bf16 compute) through the port's ServeEngine, in two deployments
     per scheme: ``fused_of(act_impl_of(cfg, scheme))``, where every FFN
     goes through ``glu_2d``, and ``act_impl_of(cfg, scheme,
     use_kernel=True)``, where every FFN SiLU goes through
     ``elementwise_2d``. Each deployment serves on the default paged
     cache (page size 16: the 160-token ring is 10 pages) and again on
     ``cache="slot"``; the ``paged_vs_slot`` line gates identical tokens.
     In every served run the kernel of the path must launch exactly 28 x
     (prefill batches + prefill chunks + decode steps) times, the other
     kernel not at all, and every bf16 ``glu_2d`` launch must take the
     ``tma_wgmma`` variant. For the two cr_spline deployments, at bf16
     and at f32 compute: ``serve_prefix`` (4 requests sharing a 4-page
     prefix, serial admission: 192 prompt tokens from cached pages, all
     pages back after the run, f32 tokens identical to prefix_cache=False)
     and ``serve_chunked`` (chunk_prefill=32 on the main prompts: f32
     tokens identical to one-shot admission; TTFT and ITL p99). Then
     ``train_fused`` / ``train_kernelized``: the cr_spline pair trains at
     full width (bf16 compute, batch 8 x seq 128) through ``TrainDriver``
     and the port's pipeline, 5 steps without remat and 2 under
     remat="block": finite losses, nothing skipped, the path's kernel
     exactly 28 launches a step (56 under "block", whose checkpoint reruns
     each block's forward), the other none; step wall ms, tokens/s, peak
     memory, and one step that must make no host sync (CUDA's sync debug
     mode).
     Then ``train_cr_fixed``: 3 steps without remat (quantization-aware,
     the straight-through gradient), no kernel launch, no host sync; the
     trainings follow the float serving runs only, so the walls of all
     three are read under the same conditions. Then
     ``serve_fixed_<scheme>``: the same served run (paged) under each of
     ``cr_fixed``, ``pwl_fixed``, ``poly_fixed``, ``rational_fixed``,
     where neither kernel may launch.
     The weights are built once; only their ``act`` leaf differs by
     scheme.
  4. kernel timings at the main path's shapes (decode 2 rows, prefill 128
     rows, 256 rows, the largest ragged prefill two slots form, and 1024,
     a training step's rows), beside the bound from the card's data-sheet
     rates, the plain version and the library yardstick (``ms`` /
     ``plain_ms`` / ``library_ms``: device time from a profiler trace, the
     sum of one call's kernel durations, mean of 30 calls with L2 flushed
     before each; ``call_ms``: median time between CUDA events around one
     call, host dispatch included). Beside every ``elementwise_2d`` case,
     ``copy_ms``: the same measure of ``y.copy_(x)`` into a preallocated
     ``y``, one launch that reads and writes the same bytes, the floor the
     kernel is held to (it computes another function: the port never
     calls it). The ``elementwise_aims`` line sets ``ms`` against
     ``copy_ms`` and the schemes against each other (information, not a
     gate). Then one decode chunk of each deployment on each cache under
     the profiler: device busy time, idle share and the top kernels per
     decode step; and one decode chunk (paged: with its write mask) that
     must make no host sync (CUDA's sync debug mode raises on any); and
     one train step of each trained deployment under the profiler
     (``trace_train_*``); the same for the ``*_fixed`` deployments
     (``trace_fixed_*``, ``trace_train_cr_fixed``). Profiling comes after serving and training
     because a profiled process keeps paying tracing costs on every later
     launch.
  5. f32 prefill logits of every deployment on the card (kernels) against
     the CPU (plain versions) on the same weights; then
     ``train_f32_vs_cpu``: one f32 train step (batch 1, seq 32, full
     width) of each trained deployment on the card and on the CPU: loss,
     gnorm and the gradients of the FFN stacks and the act leaf (per knot:
     ``knot_grad``) within 1e-4 relative. The same for each ``*_fixed``
     deployment's logits at FIXED_LOGITS_TOL and ``cr_fixed``'s step at
     FIXED_F32_TOL.
  6. the ``{"kernels": [...]}`` line: one entry per (kernel, scheme), its
     top-level times at decode and ``by_rows`` at every timed row count;
     ``elementwise_2d``'s entries add ``copy_ms``, ``glu_2d``'s the
     ``variant`` its decode launch took; the trained deployments' entries
     add ``train_launches`` (per remat run).

Then the card's ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises, exits non-zero and
prints no ok line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet (dense): 3.35 TB/s HBM3, 989 TFLOP/s bf16 tensor
# cores, 67 TFLOP/s f32 outside the tensor cores. At the full 700 W.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
SCHEMES = ("cr_spline", "pwl", "poly", "rational")
DEPTH, DEGREE = 32, 3           # ActivationConfig's deployment geometry
# every float geometry benchmarks/dse.py sweeps
DSE_GEOMS = ([(s, dict(depth=d)) for s in ("cr_spline", "pwl")
              for d in (8, 16, 32, 64)]
             + [("poly", dict(depth=d, degree=g))
                for d, g in ((4, 2), (4, 3), (8, 3), (16, 3))]
             + [("rational", dict(degree=g)) for g in (3, 5, 7)])
# the source line of each TPU kernel (src/repro/kernels/epilogue.py)
REPLACES = {"elementwise_2d": 229, "glu_2d": 289}
# the CUDA source of each port
SOURCES = {"elementwise_2d": "src/repro_torch/csrc/elementwise.cu",
           "glu_2d": "src/repro_torch/csrc/epilogue.cu"}
# what elementwise_2d is designed to reach (not gates): ms within 1.25x of
# copy_ms at each shape, the schemes within 15% of each other at decode
AIM_OVER_COPY, AIM_DECODE_SPREAD = 1.25, 0.15
SESSIONS = 3                    # profiler traces device_ms takes at most
# glu_2d checks of the TMA + wgmma variant: every decode and prefill row
# count the engine forms (M = 65 crosses a warpgroup boundary), a ragged K
# and N (TMA's out-of-bounds fill), and N = 3001, which TMA cannot address
GLU_TMA_ROWS = (1, 2, 64, 65, 128, 256, 512, 1000, 1024)
GLU_RAGGED = ((2, 1000, 3000), (65, 1000, 3000))
GLU_WMMA_CASE = (3, 1024, 3001)

SLOTS, MAX_PROMPT, MAX_LEN, CHUNK = 2, 128, 160, 8
GLU_PREFILL_MAX = 2 * MAX_PROMPT    # the largest ragged prefill two slots form
# training (the launcher's defaults): batch 8 x seq 128 = 1024 rows a
# kernel launch; 5 steps without remat, then 2 under remat="block"
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
TRAIN_RUNS = (("none", 5, 1), ("block", 2, 2))   # (remat, steps, fwd/layer)
# decode, prefill, 2 x prefill, a training step
ROWS_TIMED = (SLOTS, MAX_PROMPT, GLU_PREFILL_MAX, TRAIN_ROWS)
GRAD_ROWS = (TRAIN_ROWS, 1000)      # kernel gradient checks: train + ragged
TRAIN_F32_BATCH, TRAIN_F32_SEQ = 1, 32    # train_f32_vs_cpu
PROMPT_LENS = (17, 40, 64, 100)
MAX_NEW = 16
PAGE_SIZE = 16                  # 160 = 10 pages: the paged ring is the slot ring
# serve_prefix: 4 requests share a 4-page prefix, distinct tails
PREFIX_PAGES, PREFIX_TAILS = 4, (7, 19, 33, 50)
CHUNK_PREFILL = 32              # serve_chunked's prefill chunk
TOP_KERNELS = 5                 # device kernels named per trace line
# the bit-accurate integer datapaths (no kernel: int32 tensor ops)
FIXED_IMPLS = ("cr_fixed", "pwl_fixed", "poly_fixed", "rational_fixed")
# each scheme's fixed geometry (the reference's tests/test_fixed_datapath.py
# FIXED_GEOMS), and CR's other paper depths
FIXED_GEOMS = {"cr_spline": dict(depth=32, degree=3),
               "pwl": dict(depth=32, degree=3),
               "poly": dict(depth=8, degree=3),
               "rational": dict(depth=32, degree=5)}
FIXED_CR_DEPTHS = (8, 16, 64)
FIXED_FORMATS = ((2, 13), (2, 10), (2, 16))      # (int_bits, frac_bits)
FIXED_FUNCS = ("tanh", "sigmoid", "silu", "gelu_tanh", "softplus")
FIXED_ENGINE_SHAPE = (1024, 3072)
# fixed_engine: x's gradient through the straight-through Function, card
# against the CPU on the same inputs (max |diff| over max |cpu|)
FIXED_GRAD_TOL = 1e-6
FIXED_LEAF_GRAD_TOL = 1e-5      # the act leaf's (per knot for CR windows)
FIXED_TRAIN_RUNS = (("none", 3, 0),)   # train_cr_fixed: 3 steps, no remat
# f32 logits and one f32 train step of a *_fixed deployment, card against
# the CPU (relative): the activation is quantized to Q2.13, so a gate
# value that the card's and the CPU's GEMMs round ~1e-6 apart can land
# one LSB (1.22e-4) apart, and 28 layers carry that on. Measured on an
# H100: logits <= 1.5e-5 (rel) over the four deployments, 6e-5 is 4x
# that and half a Q2.13 LSB; the step's gradients <= 5.1e-5 (the act
# leaf per knot), where the float deployments' 1e-4 would leave 2x, so
# the step takes 2.5e-4, ~5x.
FIXED_LOGITS_TOL = 6e-5
FIXED_F32_TOL = 2.5e-4
LSB_Q213 = 2.0 ** -13


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, flush, iters: int = 30, warmup: int = 5) -> float:
    """Median time of one call as the stream sees it: CUDA events around
    each call, the L2 cache overwritten before each (a decode step finds
    its layer's weights cold: the model is far larger than L2). When the
    device outruns the host this includes the host's dispatch time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_events(fn, iters: int):
    """(name, microseconds) of every device activity of ``iters`` calls,
    from a torch.profiler (CUPTI) trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, flush, iters: int = 30, outliers: bool = False):
    """(ms, retakes): the mean device time of one call, the sum of its
    kernels' (and copies') durations in a profiler trace, L2 flushed
    before each call (the flush's own kernels are left out by name), and
    how many traces were taken again. A trace that holds none of the
    call's device activity is taken again, for every caller. With
    ``outliers`` (the copy yardstick only, whose lone-copy traces were seen
    to hold one event 16x the rest) so is a trace whose longest event
    lasts over 5x the median. At most SESSIONS traces; ms is None if none
    passed."""
    flush_names = {n for n, _ in device_events(flush.zero_, 3)}
    for retakes in range(SESSIONS):
        evs = device_events(lambda: (flush.zero_(), fn()), iters)
        own = [us for n, us in evs if n not in flush_names]
        if not own or (outliers and max(own) > 5 * statistics.median(own)):
            continue
        return sum(own) / iters / 1e3, retakes
    return None, SESSIONS


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def epilogue_ops(spec, params) -> int:
    """f32 operations of one silu epilogue element under ``spec``, counted
    from csrc/approximant.cuh: silu wiring 4, |x| 1, saturate and sign 3, and
    the scheme's block: index split 6 for the LUT schemes; cr_spline basis
    22 + 4-tap MAC 7; pwl one MAC 2; poly Horner 2 per degree; rational
    clamp + square 2, two Horner chains 4 per step, x multiply 1, seed 2,
    Newton 3 per step, product + clamp 2."""
    rows, cols = params.shape
    block = {"cr_spline": lambda: 6 + 22 + 7,
             "pwl": lambda: 6 + 2,
             "poly": lambda: 6 + 2 * (cols - 1),
             "rational": lambda: 2 + 4 * (cols - 1) + 1 + 2 + 3 * 5 + 2}
    return 4 + 1 + 3 + block[spec.scheme]()


def bf16_ulp_ok(got, ref) -> bool:
    import torch
    a = ref.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return bool(((got.float() - ref.float()).abs() <= ulp).all())


def scheme_spec(torch, epi, scheme, act, dev, depth=DEPTH, degree=DEGREE):
    """(spec, params on the card) of one epilogue under one scheme, as the
    main path resolves them: cr_spline from its spline table, the other
    schemes from the approximant registry."""
    from repro_torch.core import approximant
    if scheme == "cr_spline":
        table = epi.table_for(act, 4.0, depth)
        return epi.TableSpec.of(table), torch.as_tensor(
            table.windows, dtype=torch.float32, device=dev)
    spec = approximant.spec_for(scheme, act, depth=depth, degree=degree)
    return spec, approximant.params_on(spec, approximant.target_of(act), dev)


def acts_of(epi, scheme):
    """The epilogues a scheme has: rational's build targets tanh only, so
    it has no softplus."""
    return [a for a in epi.EPILOGUES if (scheme, a) != ("rational",
                                                       "softplus")]


def check_elementwise(torch, epi, spec, p, act, x):
    """One elementwise_2d launch against its plain version: f32 within
    rtol 1e-5 / atol 1e-6 (measured exact), bf16 within one bf16 ulp.
    Returns the max abs error."""
    y = epi.elementwise_2d(x, p, spec=spec, act=act)
    torch.cuda.synchronize()
    yp = epi.elementwise_2d_plain(x, p, spec=spec, act=act)
    err = float((y.float() - yp.float()).abs().max())
    if x.dtype == torch.float32:
        torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-6)
    elif not bf16_ulp_ok(y, yp):
        raise AssertionError(f"elementwise_2d {spec.scheme} {act} bf16 "
                             f"beyond one ulp: max err {err}")
    return err


def check_glu(torch, epi, spec, p, act, x, wg, wu):
    """One glu_2d launch against its plain version: f32 within rtol 1e-4 /
    atol 1e-5 (the K sums run in another order), bf16 within rtol 1e-2 /
    atol 1e-3 (the output is rounded once to bf16). Returns the max abs
    error."""
    tol = (1e-4, 1e-5) if x.dtype == torch.float32 else (1e-2, 1e-3)
    y = epi.glu_2d(x, wg, wu, p, spec=spec, act=act)
    torch.cuda.synchronize()
    yp = epi.glu_2d_plain(x, wg, wu, p, spec=spec, act=act)
    torch.testing.assert_close(y.float(), yp.float(), rtol=tol[0],
                               atol=tol[1])
    return float((y.float() - yp.float()).abs().max())


def check_glu_variant(torch, epi, spec, p, act, x, wg, wu, variant):
    """check_glu for one launch that must take ``variant``, plus a second
    launch on the same inputs that must give the same bits (the K split's
    cluster reduction sums in a fixed order). Returns the max abs error."""
    before = dict(epi.GLU_VARIANTS)
    err = check_glu(torch, epi, spec, p, act, x, wg, wu)
    took = [v for v in before if epi.GLU_VARIANTS[v] != before[v]]
    assert took == [variant], (took, variant, tuple(x.shape), tuple(wg.shape))
    y1 = epi.glu_2d(x, wg, wu, p, spec=spec, act=act)
    y2 = epi.glu_2d(x, wg, wu, p, spec=spec, act=act)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2), ("glu_2d not deterministic", variant,
                                 tuple(x.shape))
    return err


def glu_operands(torch, gen, dev, M, K, N, dt):
    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
    wg = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5).to(dt)
    wu = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5).to(dt)
    return x, wg, wu


def phase_kernel_checks(torch, epi, dev):
    """Each kernel against its plain version on the card, for every scheme
    and epilogue, then at every DSE geometry; returns the worst absolute
    error per (kernel, scheme)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {(k, s): 0.0 for k in REPLACES for s in SCHEMES}
    # f32 and bf16 at every row count the main path gives elementwise_2d
    # (decode SLOTS, prefill MAX_PROMPT, GLU_PREFILL_MAX), and ragged
    cases = [((r, 3072), dt) for r in ROWS_TIMED
             for dt in (torch.float32, torch.bfloat16)] \
        + [((4, 3072), torch.float32), ((37, 1000), torch.float32)]
    K, N = 1024, 3072
    for scheme in SCHEMES:
        for act in acts_of(epi, scheme):
            spec, p = scheme_spec(torch, epi, scheme, act, dev)
            errs = {}
            for shape, dt in cases:
                x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dt)
                errs[f"{list(shape)} {dt}"] = check_elementwise(
                    torch, epi, spec, p, act, x)
            worst["elementwise_2d", scheme] = max(
                worst["elementwise_2d", scheme], *errs.values())
            emit({"phase": "kernel_check", "kernel": "elementwise_2d",
                  "scheme": scheme, "act": act, "max_abs_err": errs})
        spec, p = scheme_spec(torch, epi, scheme, "silu", dev)
        errs = {}
        for M in (4, 256, 37):
            for dt in (torch.bfloat16, torch.float32):
                errs[f"{[M, K, N]} {dt}"] = check_glu(
                    torch, epi, spec, p, "silu",
                    *glu_operands(torch, gen, dev, M, K, N, dt))
        worst["glu_2d", scheme] = max(worst["glu_2d", scheme], *errs.values())
        emit({"phase": "kernel_check", "kernel": "glu_2d", "scheme": scheme,
              "act": "silu", "max_abs_err": errs})

    # the TMA + wgmma variant at every row count, ragged K and N, and the
    # wmma variant, for every scheme and epilogue; each launch repeated
    # for bitwise determinism
    for scheme in SCHEMES:
        for act in acts_of(epi, scheme):
            spec, p = scheme_spec(torch, epi, scheme, act, dev)
            errs, variants = {}, {}
            cases = [(M, K, N) for M in GLU_TMA_ROWS] + list(GLU_RAGGED)
            for M_, K_, N_ in cases + [GLU_WMMA_CASE]:
                variant = "wmma" if (M_, K_, N_) == GLU_WMMA_CASE \
                    else "tma_wgmma"
                key = f"{[M_, K_, N_]}"
                errs[key] = check_glu_variant(
                    torch, epi, spec, p, act,
                    *glu_operands(torch, gen, dev, M_, K_, N_,
                                  torch.bfloat16), variant)
                variants[key] = variant
            worst["glu_2d", scheme] = max(worst["glu_2d", scheme],
                                          *errs.values())
            emit({"phase": "kernel_check_glu_variants", "scheme": scheme,
                  "act": act, "dtype": "bfloat16", "deterministic": True,
                  "variant": variants, "max_abs_err": errs})

    # every float geometry the DSE sweeps, both kernels, f32 and bf16
    for scheme, geom in DSE_GEOMS:
        spec, p = scheme_spec(torch, epi, scheme, "silu", dev, **geom)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((256, N), generator=gen, device=dev) * 3).to(dt)
            errs[f"elementwise_2d {dt}"] = check_elementwise(
                torch, epi, spec, p, "silu", x)
            errs[f"glu_2d {dt}"] = check_glu(
                torch, epi, spec, p, "silu",
                *glu_operands(torch, gen, dev, 4, K, N, dt))
        emit({"phase": "kernel_check_dse", "scheme": scheme, "geometry": geom,
              "params_shape": list(p.shape), "act": "silu",
              "max_abs_err": errs})
    return worst


def phase_accuracy(torch, epi, dev):
    """Each scheme's kernel tanh over the whole Q2.13 input grid (2^16
    points in [-4, 4)) against torch.tanh in f64: within 0.03, the
    reference's bound (tests/test_approximant.py)."""
    grid = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.float64,
                        device=dev) / 2 ** 13
    out = {}
    for scheme in SCHEMES:
        spec, p = scheme_spec(torch, epi, scheme, "tanh", dev)
        y = epi.elementwise_2d(grid.float().reshape(1, -1), p, spec=spec,
                               act="tanh")
        err = float((y.double().reshape(-1) - torch.tanh(grid)).abs().max())
        out[scheme] = err
        assert err < 0.03, (scheme, err)
    emit({"phase": "accuracy_q213", "points": grid.numel(), "bound": 0.03,
          "max_abs_err_vs_tanh": out})


def _route_grads(torch, fn, inputs, g):
    """(output, gradients of <output, g> for every input) of ``fn``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, g)


def phase_kernel_grads(torch, epi, ops, dev):
    """Gradients through each kernel, for every scheme, at f32 and bf16, at
    the training row count and a ragged one: ``ops.act`` / ``ops.fused_glu``
    on the card (the kernel in the forward, the recompute of the plain
    version in the backward) against autograd through the plain version
    on the same inputs and upstream gradient. The gradients for x, w_gate,
    w_up and the params must be bitwise equal (both backwards run the same
    recompute); the forward outputs hold to phase 2's tolerances; each
    route launches its kernel once."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    K, N = 1024, 3072
    for scheme in SCHEMES:
        spec, p = scheme_spec(torch, epi, scheme, "silu", dev)
        out = {}
        for dt in (torch.float32, torch.bfloat16):
            for M in GRAD_ROWS:
                x = (torch.randn((M, N), generator=gen, device=dev) * 3).to(dt)
                xg, wg, wu = glu_operands(torch, gen, dev, M, K, N, dt)
                g = torch.randn((M, N), generator=gen, device=dev).to(dt)
                cases = {
                    "elementwise_2d": (
                        (x, p),
                        lambda x, p: ops.act(x, "silu", spec=spec, params=p),
                        lambda x, p: epi.elementwise_2d_plain(
                            x, p, spec=spec, act="silu", lookup="take")),
                    "glu_2d": (
                        (xg, wg, wu, p),
                        lambda x, wg, wu, p: ops.fused_glu(
                            x, wg, wu, spec=spec, params=p),
                        lambda x, wg, wu, p: epi.glu_2d_plain(
                            x, wg, wu, p, spec=spec, act="silu",
                            lookup="take"))}
                for kernel, (inputs, route, plain) in cases.items():
                    n0 = epi.LAUNCHES[kernel]
                    y, gk = _route_grads(torch, route, inputs, g)
                    torch.cuda.synchronize()
                    assert epi.LAUNCHES[kernel] == n0 + 1, kernel
                    yp, gp = _route_grads(torch, plain, inputs, g)
                    for a, b in zip(gk, gp):
                        assert torch.equal(a, b), (kernel, scheme, dt, M,
                                                   float((a.float() - b.float())
                                                         .abs().max()))
                    if kernel == "glu_2d":
                        tol = (1e-4, 1e-5) if dt == torch.float32 \
                            else (1e-2, 1e-3)
                        torch.testing.assert_close(y.float(), yp.float(),
                                                   rtol=tol[0], atol=tol[1])
                    elif dt == torch.float32:
                        torch.testing.assert_close(y, yp, rtol=1e-5,
                                                   atol=1e-6)
                    else:
                        assert bf16_ulp_ok(y, yp), (kernel, scheme, M)
                    out[f"{kernel} M={M} {dt}"] = {
                        "grads_bitwise_equal": True,
                        "max_abs_err_fwd": float(
                            (y.float() - yp.float()).abs().max()),
                        "max_abs_grad": [float(a.float().abs().max())
                                         for a in gk]}
        emit({"phase": "kernel_grad_check", "scheme": scheme, "act": "silu",
              "wrt": {"elementwise_2d": ["x", "params"],
                      "glu_2d": ["x", "w_gate", "w_up", "params"]},
              "cases": out})


def phase_kernel_times(torch, epi, dev, flush):
    """Kernel, plain version and library yardstick at the main path's
    shapes (bf16), for every scheme on the same inputs: decode rows =
    SLOTS, the longest prefill (one 128-token bucket) and GLU_PREFILL_MAX
    rows; elementwise_2d beside a copy of the same bytes. All per-call
    event times are taken before the first profiler session: a profiled
    process keeps paying per-launch tracing costs afterwards."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    K, N = 1024, 3072
    cases = {}
    for rows in ROWS_TIMED:
        x = torch.randn((rows, N), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.empty_like(x)
        xg, wg, wu = glu_operands(torch, gen, dev, rows, K, N, torch.bfloat16)
        for scheme in SCHEMES:
            spec, p = scheme_spec(torch, epi, scheme, "silu", dev)
            cases[("elementwise_2d", scheme, rows)] = dict(
                shape=[rows, N],
                extra=dict(geometry=list(epi._elementwise_geometry(
                    rows, N, x.dtype))),
                bound=bound(2 * x.numel() * 2 + p.numel() * 4,
                            epilogue_ops(spec, p) * x.numel(), F32_FLOPS),
                fns={"kernel": lambda x=x, s=spec, p=p:
                         epi.elementwise_2d(x, p, spec=s, act="silu"),
                     "plain": lambda x=x, s=spec, p=p:
                         epi.elementwise_2d_plain(x, p, spec=s, act="silu"),
                     "copy": lambda x=x, y=y: y.copy_(x)})
            nbytes = (xg.numel() + wg.numel() + wu.numel() + rows * N) * 2 \
                + p.numel() * 4
            a = (xg, wg, wu)
            cases[("glu_2d", scheme, rows)] = dict(
                shape=[rows, K, N], extra={},
                bound=bound(nbytes, 4.0 * rows * N * K, BF16_TC_FLOPS),
                fns={"kernel": lambda a=a, s=spec, p=p: epi.glu_2d(
                         *a, p, spec=s),
                     "plain": lambda a=a, s=spec, p=p: epi.glu_2d_plain(
                         *a, p, spec=s),
                     "library": lambda a=a: (torch.matmul(a[0], a[1]),
                                             torch.matmul(a[0], a[2]))})
    calls = {(key, role): call_ms(fn, flush)
             for key, c in cases.items() for role, fn in c["fns"].items()}
    timings = {}
    for key, c in cases.items():
        fns = c["fns"]
        traced = {role: device_ms(fn, flush, outliers=role == "copy")
                  for role, fn in fns.items()}
        dev_ms = {role: ms for role, (ms, _) in traced.items()}
        how = "profiler" if None not in dev_ms.values() else "events"
        if how == "events":          # a role's trace held no device activity
            dev_ms = {role: calls[(key, role)] for role in fns}
        before = dict(epi.GLU_VARIANTS)
        got = fns["kernel"]()
        plain = fns["plain"]()
        err = float((got.float() - plain.float()).abs().max())
        # the timed inputs hold to the same tolerance as phase 2's checks
        if key[0] == "glu_2d":
            torch.testing.assert_close(got.float(), plain.float(),
                                       rtol=1e-2, atol=1e-3)
        else:
            assert bf16_ulp_ok(got, plain), (key, err)
        extra = dict(c["extra"], retakes={r: n for r, (_, n) in
                                          traced.items()})
        if key[0] == "glu_2d":
            extra["variant"] = [v for v in before
                                if epi.GLU_VARIANTS[v] != before[v]][0]
        else:
            extra.update(copy_ms=dev_ms["copy"],
                         copy_call_ms=calls[(key, "copy")])
        t = dict(shape=c["shape"], dtype="bfloat16", max_abs_err=err,
                 ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                 bound_ms=c["bound"][0], bound_by=c["bound"][1],
                 library_ms=dev_ms.get("library"), timing=how,
                 call_ms=calls[(key, "kernel")],
                 plain_call_ms=calls[(key, "plain")],
                 library_call_ms=calls.get((key, "library")), **extra)
        timings[key] = t
        emit({"phase": "kernel_time", "kernel": key[0], "scheme": key[1],
              "where": {SLOTS: "decode", TRAIN_ROWS: "train"}.get(
                  key[2], "prefill"),
              "rows": key[2], **t})
    return timings


def elementwise_aims(timings) -> None:
    """elementwise_2d's design aims, from this run's timings: ``ms`` over
    ``copy_ms`` at each row count, and the spread of the schemes' decode
    ``ms`` (slowest over fastest, less one). Information, not a gate."""
    over = {rows: {s: timings[("elementwise_2d", s, rows)]["ms"]
                   / timings[("elementwise_2d", s, rows)]["copy_ms"]
                   for s in SCHEMES} for rows in ROWS_TIMED}
    decode = [timings[("elementwise_2d", s, SLOTS)]["ms"] for s in SCHEMES]
    spread = max(decode) / min(decode) - 1.0
    emit({"phase": "elementwise_aims", "ms_over_copy_ms": over,
          "aim_over_copy": AIM_OVER_COPY,
          "over_copy_met": {rows: all(r <= AIM_OVER_COPY
                                      for r in by.values())
                            for rows, by in over.items()},
          "decode_scheme_spread": spread, "aim_decode_spread":
          AIM_DECODE_SPREAD, "spread_met": spread <= AIM_DECODE_SPREAD})


def serve(torch, cfg, params, prompts, dev, max_new=MAX_NEW, **ecfg):
    from repro_torch.serve import EngineConfig, ServeEngine
    ecfg = EngineConfig(slots=SLOTS, max_prompt_len=MAX_PROMPT,
                        max_len=MAX_LEN, chunk=CHUNK, page_size=PAGE_SIZE,
                        **ecfg)
    eng = ServeEngine(cfg, params, ecfg, device=dev)
    for pr in prompts:
        eng.submit(pr, max_new=max_new)
    done = eng.run()
    return done, eng


def drive(torch, epi, cfg, params, prompts, dev, kernel, **ecfg):
    """One served run with the launch counts zeroed just before and read
    just after. The kernel of the path must launch exactly n_layers x
    forwards times (forwards: prefill batches + prefill chunks + decode
    steps, from the run's EngineStats), the other kernel not at all; with
    ``kernel`` None (a ``*_fixed`` deployment) neither kernel launches.
    Returns (token lists, engine, launches, glu variants)."""
    for counts in (epi.LAUNCHES, epi.GLU_VARIANTS):
        for k in counts:
            counts[k] = 0
    done, eng = serve(torch, cfg, params, prompts, dev, **ecfg)
    launches = dict(epi.LAUNCHES)
    variants = dict(epi.GLU_VARIANTS)
    st = eng.stats
    forwards = st.prefill_batches + st.prefill_chunks + st.decode_steps
    assert len(done) == len(prompts), done
    for c in done:
        assert len(c.tokens) == MAX_NEW and c.finish_reason == "length", c
        assert all(0 <= t < cfg.padded_vocab for t in c.tokens), c.tokens
    if kernel is None:
        assert not any(launches.values()), launches
    else:
        other = "elementwise_2d" if kernel == "glu_2d" else "glu_2d"
        assert launches[kernel] == cfg.n_layers * forwards, (launches,
                                                             forwards)
        assert launches[other] == 0, launches
    if eng.paged:
        assert eng.snapshot().pages_in_use == 0 and eng._pool.reserved == 0
    return [c.tokens for c in done], eng, launches, variants


def agreement(a, b) -> float:
    return sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb)) \
        / sum(map(len, a))


def phase_serve(torch, epi, name, cfg, params, prompts, dev, card, kernel,
                cache):
    """Warm up (every prompt, 2 tokens: every prefill bucket and insert
    shape once), then drive the main path on ``cache`` with the launch
    counts zeroed just before and read just after."""
    serve(torch, cfg, params, prompts, dev, max_new=2, cache=cache)
    toks, eng, launches, variants = drive(torch, epi, cfg, params, prompts,
                                          dev, kernel, cache=cache)
    # every bf16 FFN of the served model goes through the TMA + wgmma kernel
    assert variants == {"tma_wgmma": launches["glu_2d"], "wmma": 0,
                        "simt_f32": 0}, (variants, launches)
    st = eng.stats
    line = {"phase": name if cache == "paged" else f"{name}_slot",
            "card": card, "cache": cache, "requests": len(toks),
            "prefill_batches": st.prefill_batches,
            "decode_steps": st.decode_steps, "launches": launches,
            "glu_variants": variants,
            "prefill_tokens": st.prefill_tokens, "prefill_s": st.prefill_s,
            "insert_s": st.insert_s, "decode_tokens": st.decode_tokens,
            "decode_s": st.decode_s,
            "prefill_tokens_per_s": st.prefill_tokens_per_s,
            "decode_tokens_per_s": st.decode_tokens_per_s,
            "pages_peak": st.pages_peak}
    emit(line)
    return toks, launches, line


def latency(done_eng):
    """TTFT and ITL p99 (ms) of each completion of an engine's run."""
    done = sorted(done_eng.completions, key=lambda c: c.uid)
    return ([c.ttft_s * 1e3 for c in done], [c.itl_p99_s * 1e3 for c in done])


def phase_prefix(torch, epi, name, cfg, params32, dev, card, kernel):
    """4 requests sharing a PREFIX_PAGES-page prefix, serial admission:
    requests 1-3 prefill only their tails over the cached pages. Gates
    prefix_hit_tokens == 3 x the prefix, every page back, exact launch
    counts, and at f32 compute the same tokens as prefix_cache=False; at
    bf16 the agreement is printed."""
    import numpy as np
    rng = np.random.RandomState(2)
    shared = rng.randint(0, cfg.vocab_size, (PREFIX_PAGES * PAGE_SIZE,))
    prompts = [np.concatenate([shared, rng.randint(0, cfg.vocab_size, (n,))])
               .astype(np.int32) for n in PREFIX_TAILS]
    hit = (len(prompts) - 1) * PREFIX_PAGES * PAGE_SIZE       # 192
    out = {"phase": "serve_prefix_" + name, "card": card,
           "prompt_lens": [len(p) for p in prompts]}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        p = with_act(torch, params32, c, dev)
        serve(torch, c, p, prompts[:1], dev)                   # warm-up
        warm, eng, launches, _ = drive(torch, epi, c, p, prompts, dev,
                                       kernel, admission="serial")
        cold, ceng, _, _ = drive(torch, epi, c, p, prompts, dev, kernel,
                                 admission="serial", prefix_cache=False)
        st = eng.stats
        assert st.prefix_hit_tokens == hit, (st.prefix_hit_tokens, hit)
        assert ceng.stats.prefix_hit_tokens == 0
        agree = agreement(warm, cold)
        if dtype == "float32":
            assert warm == cold, (name, "prefix hit != cold at f32")
        out[dtype] = {"prefix_hit_tokens": st.prefix_hit_tokens,
                      "prefix_hit_rate": st.prefix_hit_rate,
                      "prefill_tokens": st.prefill_tokens,
                      "cold_prefill_tokens": ceng.stats.prefill_tokens,
                      "launches": launches[kernel],
                      "pages_peak": st.pages_peak,
                      "pages_in_use_after": eng.snapshot().pages_in_use,
                      "prefill_s": st.prefill_s,
                      "cold_prefill_s": ceng.stats.prefill_s,
                      "admitted_tokens_per_s": st.admitted_tokens_per_s,
                      "cold_admitted_tokens_per_s":
                      ceng.stats.admitted_tokens_per_s,
                      "token_agreement_vs_cold": agree}
        del p
    emit(out)


def phase_chunked(torch, epi, name, cfg, params32, prompts, dev, card,
                  kernel, one_shot_bf16):
    """chunk_prefill=CHUNK_PREFILL on the main prompts: prefill chunks
    interleaved with decode. Gates prefill_chunks > 0, exact launch
    counts, and at f32 the one-shot tokens; at bf16 the agreement with
    the main paged run is printed, with TTFT and ITL p99."""
    out = {"phase": "serve_chunked_" + name, "card": card,
           "chunk_prefill": CHUNK_PREFILL}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        p = with_act(torch, params32, c, dev)
        serve(torch, c, p, prompts[:1], dev,
              chunk_prefill=CHUNK_PREFILL)                     # warm-up
        got, eng, launches, _ = drive(torch, epi, c, p, prompts, dev, kernel,
                                      chunk_prefill=CHUNK_PREFILL)
        st = eng.stats
        assert st.prefill_chunks > 0, st
        if dtype == "float32":
            base, _, _, _ = drive(torch, epi, c, p, prompts, dev, kernel)
            assert got == base, (name, "chunked != one-shot at f32")
        else:
            base = one_shot_bf16
        ttft, itl = latency(eng)
        out[dtype] = {"prefill_chunks": st.prefill_chunks,
                      "decode_steps": st.decode_steps,
                      "launches": launches[kernel],
                      "decode_tokens_per_s": st.decode_tokens_per_s,
                      "ttft_ms": ttft, "itl_p99_ms": itl,
                      "token_agreement_vs_one_shot": agreement(got, base)}
        del p
    emit(out)


def phase_trace(torch, name, cfg, params, prompts, dev, serve_line, cache):
    """Where a decode step's time goes: one decode chunk of the same
    engine under the profiler (device activity only). Device busy time
    per step against the unprofiled wall time per step of the main run
    gives the device's idle share; the repro kernels' share is the FFN
    kernel's part; ``top_kernels`` names the TOP_KERNELS device kernels
    with the most time a step. Then one more decode chunk (with its write
    mask when paged) under CUDA's sync debug mode, which fails the run if
    the chunk makes the host wait."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.engine import make_decode_chunk
    eng = ServeEngine(cfg, params, EngineConfig(
        slots=SLOTS, max_prompt_len=MAX_PROMPT, max_len=MAX_LEN,
        chunk=CHUNK, page_size=PAGE_SIZE, cache=cache), device=dev)
    for pr in prompts[:SLOTS]:
        eng.submit(pr, max_new=MAX_NEW)
    eng.step()                          # admission + first decode chunk
    steps0 = eng.stats.decode_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step()                      # one decode chunk, ends at a sync
    steps = eng.stats.decode_steps - steps0
    # a decode chunk enqueues all its steps without one host sync: any
    # sync inside (a copy from host memory, .item(), ...) raises here
    chunk = make_decode_chunk(cfg, CHUNK, paged=eng.paged)
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk(eng.params, eng.cache, eng.state, 0, [0] * SLOTS,
              [0] * SLOTS, [0.0] * SLOTS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    wall_step = serve_line["decode_s"] / serve_line["decode_steps"]
    out = {"phase": "trace_" + name + ("" if cache == "paged" else "_slot"),
           "cache": cache, "decode_steps": steps,
           "decode_chunk_host_syncs": 0,
           "wall_ms_per_step": wall_step * 1e3, "device_events": len(evs)}
    if evs and steps:
        busy = sum(us for _, us in evs) / steps / 1e3
        mine = sum(us for n, us in evs if "repro_" in n) / steps / 1e3
        by_name = {}
        for n, us in evs:
            t, k = by_name.get(n, (0.0, 0))
            by_name[n] = (t + us, k + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
        out.update(device_busy_ms_per_step=busy,
                   device_idle_share=1.0 - busy / (wall_step * 1e3),
                   repro_kernel_ms_per_step=mine,
                   kernels_per_step=len(evs) / steps,
                   top_kernels=[{"name": n[:120],
                                 "ms_per_step": t / steps / 1e3,
                                 "launches_per_step": k / steps}
                                for n, (t, k) in top])
    emit(out)


def train_opt():
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(warmup_steps=2, decay_steps=100)


def train_pipe(cfg, batch, seq, device):
    """The launcher's pipeline (seed 1, vocab capped at 4096)."""
    from repro_torch.data import DataConfig, SyntheticPipeline
    return SyntheticPipeline(cfg, DataConfig(
        seed=1, vocab_size=min(cfg.vocab_size, 4096)), batch, seq,
        device=device)


def host_syncs(torch, fn) -> int:
    """How many times ``fn`` made the host wait for the device, as CUDA's
    sync debug mode reports them (one warning each)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("Synchronization debug mode is a prototype
    # ...") is not a sync
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def phase_train(torch, epi, name, cfg, weights, dev, card, kernel,
                runs=TRAIN_RUNS):
    """Train at full width through the port's TrainDriver and pipeline:
    TRAIN_RUNS (5 steps without remat, then 2 under remat="block",
    continuing the same run), each with the launch counts zeroed just
    before and read just after. The path's kernel must launch n_layers x
    steps times without remat and twice that under "block" (the
    checkpoint reruns each block's forward in the backward; the
    recompute backward of the kernels launches none), the other kernel
    never, every bf16 glu_2d launch on tma_wgmma; every loss finite,
    nothing skipped. With ``kernel`` None (a ``*_fixed`` deployment) and
    its ``runs``, neither kernel launches. Then one more step under
    CUDA's sync debug mode must make no host sync. Returns the line."""
    import tempfile
    from repro_torch.ft import FTConfig, TrainDriver
    from repro_torch.launch import steps as TS
    from repro_torch.optim import adamw
    params = with_act(torch, weights, cfg, dev)
    opt = adamw.init_state(params)
    pipe = train_pipe(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    line = {"phase": "train_" + name, "card": card, "arch": cfg.name,
            "layers": cfg.n_layers, "vocab": cfg.vocab_size,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "compute_dtype": cfg.compute_dtype, "scheme": cfg.act_impl
            or cfg.activation.impl, "runs": {}}
    step = 0
    with tempfile.TemporaryDirectory() as ckpt:
        ft = FTConfig(ckpt_dir=ckpt, ckpt_every=10 ** 9, log_every=0)
        for remat, n_steps, per_layer in runs:
            step_fn = TS.make_train_step(cfg, TS.TrainHyper(
                remat=remat, opt=train_opt()))
            drv = TrainDriver(step_fn, pipe, params, opt, ft,
                              start_step=step, log=lambda *_: None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for counts in (epi.LAUNCHES, epi.GLU_VARIANTS):
                for k in counts:
                    counts[k] = 0
            drv.run(n_steps)
            launches = dict(epi.LAUNCHES)
            variants = dict(epi.GLU_VARIANTS)
            peak = torch.cuda.max_memory_allocated()
            recs = drv.history
            assert [r.step for r in recs] == list(range(step, step + n_steps))
            assert all(math.isfinite(r.loss) and not r.skipped
                       for r in recs), \
                [(r.loss, r.skipped) for r in recs]
            for k, n in launches.items():
                want = per_layer * cfg.n_layers * n_steps if k == kernel \
                    else 0
                assert n == want, (remat, launches)
            if kernel == "glu_2d":
                assert variants == {"tma_wgmma": launches["glu_2d"],
                                    "wmma": 0, "simt_f32": 0}, variants
            walls = [r.wall_s * 1e3 for r in recs]
            steady = statistics.median(walls[1:] if len(walls) > 1
                                       else walls)
            line["runs"][remat] = {
                "steps": n_steps, "first_step": step,
                "losses": [r.loss for r in recs],
                "gnorms": [r.gnorm for r in recs],
                "skipped": sum(r.skipped for r in recs),
                "launches": launches, "glu_variants": variants,
                "launches_per_step": launches.get(kernel, 0) / n_steps,
                "step_wall_ms": walls, "step_wall_ms_median": steady,
                "train_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
                "max_memory_allocated_gb": peak / 1e9}
            params, opt, step = drv.params, drv.opt_state, drv.step
        step_fn = TS.make_train_step(cfg, TS.TrainHyper(remat="none",
                                                        opt=train_opt()))
        batch = pipe(step)
        torch.cuda.synchronize()
        line["host_syncs_per_step"] = host_syncs(
            torch, lambda: step_fn(params, opt, batch, step))
        torch.cuda.synchronize()
    emit(line)
    # the step enqueues its work without waiting: the driver's read of
    # the loss is the step's one sync
    assert line["host_syncs_per_step"] == 0, line["host_syncs_per_step"]
    return line


def phase_train_trace(torch, name, cfg, weights, dev, train_line):
    """Where a train step's time goes: one step (remat none) under the
    profiler, after one warm step, against the unprofiled median wall
    time per step of the train run: device busy ms, idle share, kernels
    per step and the top kernels with their launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps as TS
    from repro_torch.optim import adamw
    params = with_act(torch, weights, cfg, dev)
    opt = adamw.init_state(params)
    batch = train_pipe(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)(0)
    step_fn = TS.make_train_step(cfg, TS.TrainHyper(remat="none",
                                                    opt=train_opt()))
    params, opt, m = step_fn(params, opt, batch, 1)
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, m = step_fn(params, opt, batch, 2)
        float(m["loss"])
    evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    wall = train_line["runs"]["none"]["step_wall_ms_median"]
    busy = sum(us for _, us in evs) / 1e3
    by_name = {}
    for n, us in evs:
        t, k = by_name.get(n, (0.0, 0))
        by_name[n] = (t + us, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    emit({"phase": "trace_train_" + name, "remat": "none",
          "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy / wall if evs else None,
          "repro_kernel_ms_per_step": sum(us for n, us in evs
                                          if "repro_" in n) / 1e3,
          "kernels_per_step": len(evs),
          "top_kernels": [{"name": n[:120], "ms_per_step": t / 1e3,
                           "launches_per_step": k}
                          for n, (t, k) in top]})


def knot_grad(torch, g):
    """The gradient per knot of a CR window leaf's gradient ([depth, 4]:
    window k holds knots k-1 .. k+2): the sum over the entries that hold
    the same knot, in f64. Per entry, the gradient moves a whole
    element's contribution from window k's third entry to window k+1's
    second when the element's input crosses the knot between them, so a
    difference in the last bits of a gate value (another GEMM's sum order)
    moves it by up to ~1% of its largest entry at full width; per knot it
    is continuous."""
    depth = g.shape[0]
    idx = (torch.arange(depth)[:, None] + torch.arange(4)[None, :]).reshape(-1)
    return torch.zeros(depth + 3, dtype=torch.float64).index_add_(
        0, idx, g.double().reshape(-1))


def phase_train_f32_vs_cpu(torch, M, TS, name, cfg, weights, weights_cpu,
                           dev, tol):
    """One f32 train step (step 1: at step 0 the warmup learning rate is
    0) on the card (kernels) and on the CPU (plain versions), on the same
    weights and batch, at full width: the loss and gnorm of the step, and
    the gradients of the loss for the FFN stacks and the act leaf (per
    knot, ``knot_grad``; per window entry printed), each against the CPU
    within ``tol`` relative (max |diff| over max |cpu|)."""
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_batch = train_pipe(cfg32, TRAIN_F32_BATCH, TRAIN_F32_SEQ, "cpu")(0)
    engine = TS.make_engine(cfg32)
    step_fn = TS.make_train_step(cfg32, TS.TrainHyper(remat="none",
                                                      opt=train_opt()))
    got = {}
    for where, tree in ((dev, weights), ("cpu", weights_cpu)):
        params = with_act(torch, tree, cfg32, where)
        batch = {k: v.to(where) for k, v in cpu_batch.items()}
        _, _, m = step_fn(params, adamw.init_state(params), batch, 1)
        leaf = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = M.loss_fn(leaf, batch, cfg32, engine, remat="none")
        leaves = tree_leaves(leaf)
        by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda t: by_id[id(t)], leaf)
        got[str(where)] = {
            "loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "grads": {f"ffn/{k}": v.cpu() for k, v in
                      grads["blocks"]["ffn"].items()}
            | {f"act/{k}": v.cpu() for k, v in grads["act"].items()}}
        del params, leaf, grads, by_id, leaves
    card, cpu = got[str(dev)], got["cpu"]
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("loss", "gnorm")}
    windows_rel = {}
    for k, g in cpu["grads"].items():
        a = card["grads"][k]
        if k.startswith("act/"):
            windows_rel[k] = float((a - g).abs().max() / g.abs().max())
            a, g = knot_grad(torch, a), knot_grad(torch, g)
        rel["grad " + k] = float((a - g).abs().max() / g.abs().max())
    line = {"phase": "train_f32_vs_cpu", "deployment": name,
            "layers": cfg.n_layers, "batch": TRAIN_F32_BATCH,
            "seq": TRAIN_F32_SEQ, "step": 1,
            "loss": {"card": card["loss"], "cpu": cpu["loss"]},
            "gnorm": {"card": card["gnorm"], "cpu": cpu["gnorm"]},
            "rel": rel, "tolerance_rel": tol,
            "act_grad_compared": "per knot",
            "act_grad_per_window_entry_rel": windows_rel}
    emit(line)
    assert all(v <= tol for v in rel.values()), (name, rel)


def phase_f32_vs_cpu(torch, np, M, TS, cfg, params, params_cpu, dev):
    """One ragged f32 prefill on the card (kernels) and on the CPU (plain
    versions), same weights; returns the relative max-norm difference."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    lens = [40, 23]
    out = {}
    for where, tree in ((dev, params), ("cpu", params_cpu)):
        p = M.compute_params(with_act(torch, tree, cfg32, where), cfg32)
        batch = {"tokens": torch.as_tensor(toks, device=where),
                 "lengths": torch.as_tensor(lens, dtype=torch.int32,
                                            device=where)}
        logits, _ = M.prefill_fn(p, batch, cfg32, TS.make_engine(cfg32),
                                 capacity=64)
        out[where] = logits.float().cpu()
        del p
    diff = float((out[dev] - out["cpu"]).abs().max())
    scale = float(out["cpu"].abs().max())
    return diff, scale


def phase_fixed_grid(torch, dev):
    """Each scheme's integer datapath (``approximant.fixed_block``) at its
    fixed geometry, and CR at its other paper depths, over the whole
    lattice at Q2.13 (2^16 points), Q2.10 and Q2.16, on the card from a ROM
    on the card: bit-identical to the same call on the CPU, int32 out, and
    the ROM requantized from the f32 params on the card equal to the ROM.
    Then ``tanh_error(..., datapath="fixed")`` per scheme on the card (CR
    at depth 64 must come to one Q2.13 LSB, within 5%) and
    ``table_1_2("qout")`` beside the paper's Tables I/II."""
    from repro_torch.core import approximant as apx
    from repro_torch.core import error_analysis as ea
    from repro_torch.core import fixed_point as fp
    cpu = torch.device("cpu")
    cases = list(FIXED_GEOMS.items()) + [
        ("cr_spline", dict(depth=d, degree=3)) for d in FIXED_CR_DEPTHS]
    lattices = {}
    for scheme, geom in cases:
        for ib, fb in FIXED_FORMATS:
            fmt = fp.QFormat(ib, fb)
            spec = apx.spec_for(scheme, "tanh", int_bits=ib, frac_bits=fb,
                                **geom)
            xq = torch.as_tensor(fp.quantize(fp.representable_grid(fmt), fmt))
            rom = apx.fixed_params_on(spec, "tanh", dev)
            y = apx.fixed_block(xq.to(dev), rom, spec)
            req = apx.requantize(apx.params_on(spec, "tanh", dev), spec)
            torch.cuda.synchronize()
            want = apx.fixed_block(xq, apx.fixed_params_on(spec, "tanh", cpu),
                                   spec)
            assert y.device == dev and y.dtype == torch.int32, (y.device,
                                                                y.dtype)
            assert torch.equal(y.cpu(), want), (scheme, geom, str(fmt), int(
                (y.cpu() != want).sum()))
            assert torch.equal(req, rom), (scheme, geom, str(fmt))
            lattices[f"{scheme} d{geom['depth']} g{geom['degree']} "
                     f"{fmt}"] = xq.numel()
    errors = {}
    for scheme, geom in FIXED_GEOMS.items():
        st = ea.tanh_error(scheme, geom["depth"], datapath="fixed",
                           degree=geom["degree"], device=dev)
        errors[scheme] = {"depth": geom["depth"], "degree": geom["degree"],
                          "max": st.max, "rms": st.rms}
    cr = {d: ea.tanh_error("cr", d, datapath="fixed", device=dev)
          for d in (8, 16, 32, 64)}
    assert abs(cr[64].max - LSB_Q213) <= 0.05 * LSB_Q213, cr[64]
    emit({"phase": "fixed_grid", "bitwise_card_eq_cpu": True,
          "rom_requantized_on_card_eq_rom": True, "lattice_points": lattices,
          "tanh_error_fixed": errors,
          "cr_fixed_by_depth": {d: {"max": st.max, "rms": st.rms}
                                for d, st in cr.items()},
          "cr_depth64_max_over_lsb": cr[64].max / LSB_Q213,
          "table_1_2_qout": [
              {k: r[k] for k in ("period", "depth", "pwl_rms", "cr_rms",
                                 "pwl_max", "cr_max", "paper")}
              for r in ea.table_1_2("qout", device=dev)]})


def _same_bits(torch, a, b) -> bool:
    """Equal values, NaN at the same places (a NaN's payload aside)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0, a), torch.where(nan, 0, b))


def _float_close(torch, a, b) -> bool:
    """The non-finite values equal, the finite ones within f32 1e-6
    absolute + 1e-6 relative, or one bf16 ulp."""
    fin = torch.isfinite(b)
    if not (torch.equal(fin, torch.isfinite(a))
            and _same_bits(torch, a[~fin], b[~fin])):
        return False
    a, b = a[fin], b[fin]
    if a.dtype == torch.bfloat16:
        return bf16_ulp_ok(a, b)
    return bool(((a - b).abs() <= 1e-6 + 1e-6 * b.abs()).all())


def _rel(a, b) -> float:
    """max |a - b| over max |b|, in f64 on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def phase_fixed_engine(torch, base, dev):
    """Every nonlinearity of each ``*_fixed`` engine as the model
    configures it, on FIXED_ENGINE_SHAPE f32 and bf16 inputs from one seed
    with NaN and ±inf among them: the card's output bitwise equal to the
    CPU's for the four that run the integer tanh unit, and neither kernel
    launched. softplus is the float residual spline under every
    ``*_fixed`` impl (as in the reference), whose 4-tap sum the card
    reduces in another order: held to ``_float_close``. Then the straight-through
    gradients on finite inputs: x's through tanh and silu of the unbound
    engine and through sigmoid of the bound one (the model's route, its
    ROM requantized from the act leaf on every call) within
    FIXED_GRAD_TOL of the CPU, and the act leaf's (per knot for CR
    windows, ``knot_grad``; per entry otherwise) within
    FIXED_LEAF_GRAD_TOL."""
    from repro_torch.core.activations import (ActivationEngine,
                                              init_act_params)
    from repro_torch.kernels import epilogue as epi
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(FIXED_ENGINE_SHAPE, generator=gen) * 3
    xs = x.clone()
    xs.view(-1)[:5] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), 0.0, -0.0])
    g = torch.randn(FIXED_ENGINE_SHAPE, generator=gen)
    for impl in FIXED_IMPLS:
        cfg = dataclasses.replace(base.activation, impl=impl)
        eng = ActivationEngine(cfg)
        n0 = dict(epi.LAUNCHES)
        for dt in (torch.float32, torch.bfloat16):
            xc = xs.to(dt)
            xd = xc.to(dev)
            for fn in FIXED_FUNCS:
                yd = getattr(eng, fn)(xd)
                yc = getattr(eng, fn)(xc)
                assert yd.device == dev and yd.dtype == dt, (impl, fn)
                same = _float_close if fn == "softplus" else _same_bits
                assert same(torch, yd.cpu(), yc), (
                    impl, fn, dt, int((yd.cpu() != yc).sum()))
        assert epi.LAUNCHES == n0, (impl, epi.LAUNCHES, n0)
        tag = cfg.tag()
        leaf = torch.as_tensor(init_act_params([cfg])[tag])
        got = {}
        for where in (dev, "cpu"):
            out = {}
            for fn in ("tanh", "silu"):
                xv = x.to(where).requires_grad_()
                (gx,) = torch.autograd.grad(getattr(eng, fn)(xv), xv,
                                            g.to(where))
                out[f"x via {fn}"] = gx
            xv = x.to(where).requires_grad_()
            pv = leaf.to(where).requires_grad_()
            bound = ActivationEngine(cfg, act_params=pv)
            gx, gp = torch.autograd.grad(bound.sigmoid(xv), (xv, pv),
                                         g.to(where))
            out["x via bound sigmoid"] = gx
            out["act leaf via bound sigmoid"] = gp
            got[str(where)] = out
        rel = {}
        for k, gc in got["cpu"].items():
            gd = got[str(dev)][k]
            assert torch.isfinite(gd).all(), (impl, k)
            if k.startswith("act") and impl == "cr_fixed":
                gd, gc = knot_grad(torch, gd.cpu()), knot_grad(torch, gc)
            rel[k] = _rel(gd, gc)
        emit({"phase": "fixed_engine", "impl": impl, "tag": tag,
              "shape": list(FIXED_ENGINE_SHAPE), "funcs": list(FIXED_FUNCS),
              "dtypes": ["float32", "bfloat16"],
              "nan_inf_in_input": True,
              "bitwise_card_eq_cpu": [f for f in FIXED_FUNCS
                                      if f != "softplus"],
              "float_close_card_cpu": ["softplus"],
              "kernel_launches": 0, "grad_rel": rel,
              "act_grad_compared": "per knot" if impl == "cr_fixed"
              else "per entry",
              "tolerance_rel": {"x": FIXED_GRAD_TOL,
                                "act": FIXED_LEAF_GRAD_TOL}})
        for k, v in rel.items():
            tol = FIXED_LEAF_GRAD_TOL if k.startswith("act") \
                else FIXED_GRAD_TOL
            assert v <= tol, (impl, k, v, tol)


def with_act(torch, params, cfg, device):
    """``params`` with the ``act`` leaf of ``cfg``'s scheme: the weights
    are shared, only the approximant params differ between schemes."""
    from repro_torch.core.activations import init_act_params
    out = {k: v for k, v in params.items() if k != "act"}
    out["act"] = {tag: torch.as_tensor(arr, device=device) for tag, arr in
                  init_act_params(cfg.layer_activation_configs()).items()}
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.configs import registry
    from repro_torch.configs.common import act_impl_of, fused_of
    from repro_torch.kernels import _build
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M

    # 1. build and device
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    emit({"phase": "build", "build_s": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sources": [str(s.relative_to(ROOT)) for s in _build.sources()]})

    # 2. kernels against their plain versions, and each scheme's accuracy
    worst = phase_kernel_checks(torch, epi, dev)
    phase_kernel_grads(torch, epi, ops, dev)

    phase_accuracy(torch, epi, dev)

    # 2b. the bit-accurate integer datapaths: card against CPU, bitwise
    base = registry.get("qwen3-0.6b")
    phase_fixed_grid(torch, dev)
    phase_fixed_engine(torch, base, dev)

    # 3. serve qwen3-0.6b at full width through each kernel under each
    #    scheme, before any profiler session (see phase_kernel_times)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, base.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    # (phase suffix, scheme, kernel of the path, config); the cr_spline
    # pair is the first slice's
    deployments = [("fused", "cr_spline", "glu_2d", fused_of(base)),
                   ("kernelized", "cr_spline", "elementwise_2d",
                    act_impl_of(base, "cr_spline", use_kernel=True))]
    for scheme in SCHEMES[1:]:
        deployments += [
            (f"fused_{scheme}", scheme, "glu_2d",
             fused_of(act_impl_of(base, scheme))),
            (f"kernelized_{scheme}", scheme, "elementwise_2d",
             act_impl_of(base, scheme, use_kernel=True))]
    weights = M.materialize_params(base, seed=0, device=dev)
    served = {}
    for name, scheme, kernel, cfg in deployments:
        params = with_act(torch, weights, cfg, dev)
        # the two caches run in turns, paged first in every other
        # deployment, so neither always meets a colder host
        order = ("paged", "slot") if len(served) % 2 == 0 \
            else ("slot", "paged")
        runs = {cache: phase_serve(torch, epi, "serve_" + name, cfg, params,
                                   prompts, dev, card, kernel, cache)
                for cache in order}
        (toks, launches, line), (stoks, _, sline) = runs["paged"], \
            runs["slot"]
        emit({"phase": "paged_vs_slot", "deployment": name,
              "tokens_identical": toks == stoks,
              "decode_tokens_per_s": {"paged": line["decode_tokens_per_s"],
                                      "slot": sline["decode_tokens_per_s"]},
              "prefill_tokens_per_s": {
                  "paged": line["prefill_tokens_per_s"],
                  "slot": sline["prefill_tokens_per_s"]}})
        # page_size divides the capacity: the gathered ring has the slot
        # ring's width, order and values, so the arithmetic is the same
        assert toks == stoks, (name, "paged != slot tokens")
        served[name] = dict(toks=toks, launches=launches, line=line,
                            slot_line=sline, params=params)
    agree = {}
    for scheme in SCHEMES:
        f, k = [served[n]["toks"] for n, s, _, _ in deployments if s == scheme]
        agree[scheme] = agreement(f, k)
    emit({"phase": "token_agreement", "fused_vs_kernelized": agree,
          "note": "bf16 deployments differ by design; information only"})
    # prefix sharing and chunked prefill on the cr_spline pair, bf16 and f32
    for name, scheme, kernel, cfg in deployments:
        if scheme == "cr_spline":
            phase_prefix(torch, epi, name, cfg, weights, dev, card, kernel)
            phase_chunked(torch, epi, name, cfg, weights, prompts, dev, card,
                          kernel, served[name]["toks"])
    # train the cr_spline pair at full width, also before any profiling,
    # then cr_fixed (quantization-aware: the straight-through gradient)
    trained = {name: phase_train(torch, epi, name, cfg, weights, dev, card,
                                 kernel)
               for name, scheme, kernel, cfg in deployments
               if scheme == "cr_spline"}
    fixed_deps = [(f"fixed_{scheme}", impl, act_impl_of(base, impl))
                  for scheme, impl in zip(SCHEMES, FIXED_IMPLS)]
    _, fixed_train, fixed_train_cfg = fixed_deps[0]       # cr_fixed
    fixed_trained = phase_train(torch, epi, fixed_train, fixed_train_cfg,
                                weights, dev, card, None,
                                runs=FIXED_TRAIN_RUNS)
    torch.cuda.empty_cache()
    # serve under each bit-accurate integer datapath: no kernel launches
    for name, _, cfg in fixed_deps:
        params = with_act(torch, weights, cfg, dev)
        _, _, line = phase_serve(torch, epi, "serve_" + name, cfg, params,
                                 prompts, dev, card, None, "paged")
        served[name] = dict(line=line, params=params)

    # 4. kernel timings, then where a decode step's time goes
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = phase_kernel_times(torch, epi, dev, flush)
    elementwise_aims(timings)
    for name, _, _, cfg in deployments:
        for cache, key in (("paged", "line"), ("slot", "slot_line")):
            phase_trace(torch, name, cfg, served[name]["params"], prompts,
                        dev, served[name][key], cache)
        del served[name]["params"]
        if name in trained:
            phase_train_trace(torch, name, cfg, weights, dev, trained[name])
    for name, _, cfg in fixed_deps:
        phase_trace(torch, name, cfg, served[name]["params"], prompts, dev,
                    served[name]["line"], "paged")
        del served[name]["params"]
    phase_train_trace(torch, fixed_train, fixed_train_cfg, weights, dev,
                      fixed_trained)
    del flush
    torch.cuda.empty_cache()

    # 5. f32 prefill logits: card (kernels) vs CPU (plain versions)
    tol = 1e-4
    weights_cpu = _tree_to(weights, "cpu")
    for name, _, _, cfg in deployments:
        diff, scale = phase_f32_vs_cpu(torch, np, M, TS, cfg, weights,
                                       weights_cpu, dev)
        rel = diff / scale
        emit({"phase": "f32_vs_cpu", "deployment": name, "layers":
              cfg.n_layers, "max_abs_diff": diff, "max_abs_logit": scale,
              "rel": rel, "tolerance_rel": tol})
        assert rel <= tol, (name, rel)
    # the same under each integer datapath, at FIXED_LOGITS_TOL (see there)
    for name, _, cfg in fixed_deps:
        diff, scale = phase_f32_vs_cpu(torch, np, M, TS, cfg, weights,
                                       weights_cpu, dev)
        rel = diff / scale
        emit({"phase": "f32_vs_cpu", "deployment": name, "layers":
              cfg.n_layers, "max_abs_diff": diff, "max_abs_logit": scale,
              "rel": rel, "tolerance_rel": FIXED_LOGITS_TOL})
        assert rel <= FIXED_LOGITS_TOL, (name, rel)
    # one f32 train step: card (kernels) vs CPU (plain versions)
    for name, _, _, cfg in deployments:
        if name in trained:
            phase_train_f32_vs_cpu(torch, M, TS, name, cfg, weights,
                                   weights_cpu, dev, tol)
    phase_train_f32_vs_cpu(torch, M, TS, fixed_train, fixed_train_cfg,
                           weights, weights_cpu, dev, FIXED_F32_TOL)
    del weights, weights_cpu

    # 6. the kernels line: one entry per (kernel, scheme), its launches on
    #    its own deployment's run, its timings at the decode shape (the
    #    main path's most frequent launch) and at every timed row count
    kernels = []
    by_keys = {"elementwise_2d": ("ms", "copy_ms", "call_ms", "plain_ms",
                                  "bound_ms", "max_abs_err", "geometry"),
               "glu_2d": ("ms", "call_ms", "plain_ms", "library_ms",
                          "bound_ms", "max_abs_err", "variant")}
    for name, scheme, kernel, _ in deployments:
        t = timings[(kernel, scheme, SLOTS)]
        by_rows = {rows: {k: timings[(kernel, scheme, rows)][k]
                          for k in by_keys[kernel]} for rows in ROWS_TIMED}
        own = ({"variant": t["variant"]} if kernel == "glu_2d"
               else {"copy_ms": t["copy_ms"]})
        kernels.append({
            "name": kernel if scheme == "cr_spline" else
            f"{kernel}[{scheme}]", "scheme": scheme, "route": "cuda",
            "source": SOURCES[kernel],
            "replaces": f"src/repro/kernels/epilogue.py:{REPLACES[kernel]}",
            "launches": served[name]["launches"][kernel],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "dtype": t["dtype"], "timing": t["timing"],
            "call_ms": t["call_ms"],
            "max_abs_err_checks": worst[(kernel, scheme)],
            **own, "by_rows": by_rows})
        if name in trained:
            kernels[-1]["train_launches"] = {
                remat: run["launches"][kernel]
                for remat, run in trained[name]["runs"].items()}
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
