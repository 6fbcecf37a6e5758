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
     geometry ``benchmarks/dse.py`` sweeps. ``glu_2d``'s TMA variants
     (bf16 ``tma_wgmma_gemm`` from ``epilogue.GLU_GEMM_ROWS`` (512) rows
     at K up to ``epilogue.GLU_GEMM_MAX_K`` (2048), else ``tma_wgmma``;
     f32 ``tma_f32``) at M = 1, 2, 64,
     65, 128, 256, 512, 1000 and 1024 (K=1024, N=3072; 512, 1000 and 1024
     take ``tma_wgmma_gemm`` at bf16; tma_f32 runs 64-row M tiles above 64) and
     at a ragged K=1000, N=3000, and the
     variants for operands TMA cannot address (bf16 ``wmma``, f32
     ``simt_f32``) at N=3001, for every scheme and epilogue: each case
     asserts the variant it took (``tma_variant``) and that a repeated
     launch gives the same bits. Then gradients through both
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
     Then ``grouped_mm``: the types ``torch._grouped_mm`` (the ragged MoE
     path's grouped GEMM) takes on the card, against a loop over the
     groups, no host sync.
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
     kernel not at all, and every ``glu_2d`` launch must take the variant
     its type and rows give (``tma_variant``: every served bf16 launch,
     up to 256 rows, ``tma_wgmma``; every f32 one ``tma_f32``; a bf16
     train launch, 1024 rows a rank or 512 a sharded one,
     ``tma_wgmma_gemm`` at K up to 2048, else ``tma_wgmma``), counted
     exactly by variant. For the two
     cr_spline deployments, at bf16
     and at f32 compute: ``serve_prefix`` (4 requests sharing a 4-page
     prefix, serial admission: 192 prompt tokens from cached pages, all
     pages back after the run, f32 tokens identical to prefix_cache=False)
     and ``serve_chunked`` (chunk_prefill=32 on the main prompts: f32
     tokens identical to one-shot admission; TTFT and ITL p99). Then
     ``train_fused`` / ``train_kernelized``: the cr_spline pair trains at
     full width (bf16 compute, batch 8 x seq 128) through ``TrainDriver``
     and the port's pipeline, 5 steps without remat and 2 under
     remat="block": finite losses, nothing skipped, each kernel exactly
     ``launches_per_forward`` x steps launches (28 a step for the path's
     kernel; twice that under "block", whose checkpoint reruns each
     block's forward), the other none; step wall ms, tokens/s, peak
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
     Then (3b) the other archs at full width, each built, served and
     freed before the next (random weights from seed 0, bf16, the same
     schedule): olmo-1b (16 layers), qwen2.5-3b (36), yi-34b (8 of 60),
     mixtral-8x22b (2 of 56), llama4-scout-17b-a16e (2 of 48),
     qwen2-vl-2b (28, M-RoPE), hymba-1.5b (32, attention and Mamba in
     parallel), musicgen-large (48, [S, 4] codebook prompts) and
     falcon-mamba-7b (64, Mamba-1), the cut depths listed as
     ``reduced``; each cr_spline fused (where it has a gated FFN) and
     kernelized, and the MoE archs kernelized under moe_impl="ragged"
     too. The Mamba archs ask for chunked prefill as well and must keep
     one-shot admission at exact buckets (one prefill a prompt), without
     prefix sharing; falcon-mamba must fall back from the paged cache to
     the slot contract. Then qwen3-0.6b under per-layer assignments
     (``serve_per_layer_*``): fused and kernelized over cr_spline / pwl /
     poly / rational blocks of 7 layers (28 launches a forward), a
     kernelized cr_spline / cr_fixed half-and-half (14), and every layer
     pinned to cr_spline, which must serve the uniform kernelized run's
     tokens. In every counted served run of phase 3 each kernel must
     launch exactly ``launches_per_forward(cfg)`` x forwards times, every
     glu_2d launch on its type's variant, and each launch's shape is
     recorded (``ShapeLog``; the ``kernel_shapes`` of each serve line).
     Then (3c) ``train_<arch>``: the families trained at full width as
     the qwen3 pair is (TRAIN_ARCH_RUNS: qwen2-vl-2b and hymba-1.5b
     fused, musicgen-large and falcon-mamba-7b kernelized, mixtral-8x22b
     kernelized under gshard and ragged; 2 steps without remat, 1 under
     "block"), their state updated in place (TrainHyper(donate=True)),
     the depth cut where the card cannot hold it (``reduced``): the same
     gates, each kernel's launches from ``launches_per_forward``.
     The same runs train (ROADMAP item 9c) olmo-1b fused (16 layers),
     qwen2.5-3b kernelized (36), yi-34b fused (4 of 60), llama4-scout
     fused (1 of 48: the shared expert's glu_2d at K = 5120), and
     qwen3-0.6b under pwl, poly and rational, fused and kernelized, and
     under two per-layer assignments; each train line names its
     ``scheme``.
     Then (3d) the multi-replica tier on qwen3-0.6b fused (bf16):
     ``serve_routed`` (2 in-process replicas through the launcher's
     ``serve_routed``, 8 requests: tokens equal one engine's, launches
     exact over the fleet, one copy of the weights), and
     ``serve_routed_backpressure`` (queue_limit 2, reject and shed, 12
     requests: every request accounted for, survivors' tokens equal one
     engine's, every page back), ``serve_routed_autoscale`` (1..3
     replicas: a burst scales up, idle steps drain and retire, nothing
     lost), ``serve_process_replica`` (an engine in a spawned worker with
     its own CUDA context: the in-process replica's tokens, exit code 0).
     Then ``serve_tp_*`` (ROADMAP item 12): TP_WORLD ranks spawned by
     ``launch/mesh.py::spawn_ranks`` share the card over gloo (NCCL
     refuses two ranks on one device) and serve TP_RUNS through
     ``ServeEngine(mesh=)``: qwen3-0.6b (4 of 28 layers) in bf16 at TP 2
     and 4 on the paged pool, at TP 2 on the slot cache, chunked and
     kernelized, and at f32 at TP 2 and 4; at f32 and cut depths
     qwen2.5-3b at TP 4 (kv heads whole), hymba-1.5b (heads whole, Mamba
     sharded), musicgen-large (codebook planes) and mixtral-8x22b
     (ragged) at TP 2. Every rank holds the same logits and tokens, each
     rank's launches are exact and equal TP=1's, prefill logits are
     within TP_F32_TOL (f32) / TP_BF16_TOL (bf16) of TP=1's, and the f32
     runs' tokens equal TP=1's (bf16 ones agree up to near-ties: see
     TP_BF16_TOL); each line prints the backend,
     launches by shape, collectives a forward, peak memory a rank and the
     rates (qwen3's paged lines: a TP decode chunk's collectives and host
     syncs)
     (processes sharing one card: information, not a speed claim). The
     TP 2 runs alternate between two pairs of ranks serving at once. The
     shard shapes join the served-shape checks and phase 4's timings.
     Then ``train_sharded_*`` (ROADMAP item 12b): the same four ranks
     train TRAIN_SHARDED_RUNS through ``make_train_step(mesh=)`` and a
     sharded ``TrainDriver`` (FSDP of the embed dim over ``data``, TP
     over ``model``, each rank storing its blocks of the params and of
     AdamW's state): qwen3-0.6b at 4 of 28 layers in bf16 at (data,
     model) = (2, 2), fused and kernelized, 3 steps at a global 8 x 128
     (finite, unskipped, loss and gnorm the same bits on every rank, each
     rank's launches exactly ``launches_per_forward`` x forwards, the
     other kernel none, bf16 glu_2d on ``tma_wgmma_gemm``; step ms,
     collectives and MB a step per axis, peak GB a rank and the host
     syncs of the last step printed); then at f32 qwen3-0.6b (4 of 28
     layers) at (2, 2), (4, 1) and (1, 4) and hymba-1.5b (4 of 32) at
     (2, 2), each held against the one-process step on the card (rank 0
     runs it first; step 1 from the same weights and batch): loss and
     gnorm, every gathered gradient leaf (the act leaf per knot) and
     every leaf's update, within TRAIN_SHARDED_* limits.
     Then (3e) the autotuner (``repro_torch.core.autotune``):
     ``autotune_grid`` (every FULL_GRID candidate and the baseline scored
     on the card: tags, gates and max_err equal to the CPU's bit for
     bit), ``autotune_olmo-1b`` (olmo-1b at full width, bf16, trained 40
     steps at batch 8 x seq 64 under the uniform cr_fixed depth-64
     baseline, then the greedy per-layer search: every layer assigned,
     loss at most the baseline's, the final assignment's loss bits
     reproduced, no kernel launch), ``serve_autotuned_olmo-1b`` (the
     tuned assignment served on the paged cache, no host sync in a
     decode chunk) and ``autotune_f32_vs_cpu`` (its f32 eval loss, card
     against CPU, AUTOTUNE_F32_TOL); then ``examples``: the four
     examples/torch_*.py in-process on the card (the quickstart launches
     elementwise_2d once; train_lm twice into one checkpoint directory,
     the second resuming).
     Then ``kernel_check_served_shapes``: both kernels at every distinct
     shape and type the served and trained runs launched them at, for
     every scheme, against their plain versions at phase 2's tolerances,
     glu_2d on the variant the launch took, a repeated launch
     bit-identical.
     Then (3f) ``roofline_calibration_*`` (ROADMAP item 13): qwen3-0.6b
     fused and kernelized, one decode chunk (CHUNK steps, SLOTS rows, the
     slot cache) and one train step (TRAIN_BATCH x TRAIN_SEQ) counted by
     ``analysis/hlo_cost.py::count_step`` on the card's tensors and on
     meta tensors: FLOPs by class, bytes and kernel counts equal, the
     kernel counts equal to the launches; each count's roofline (the
     H100 data sheet's rates) against the step's measured wall, device
     busy time and MFU (no speed gate); the meta count's step peak
     against ``max_memory_allocated()`` over the train step, within
     CALIB_MEM_TOL. Meanwhile the dry-run CLI runs in subprocesses on the
     host (DRYRUN_CLI: qwen3-0.6b on the single-pod mesh, mixtral-8x22b
     ``decode_32k`` on the multi-pod one, over a fake process group):
     every DRYRUN_OK cell must report ok.
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
     gate). Then one decode chunk (TRACE_CHUNK steps) of each deployment
     on each cache under the profiler: device busy time, idle share and
     the top kernels per decode step; and one decode chunk (paged: with
     its write mask) that must make no host sync (CUDA's sync debug mode
     raises on any); and
     one train step of each trained deployment under the profiler
     (``trace_train_*``); the same for the ``*_fixed`` deployments
     (``trace_fixed_*``, ``trace_train_cr_fixed``), then the per-layer
     runs' and the archs' (each arch rebuilt from its seed), and one train
     step each of falcon-mamba and hymba at a cut depth
     (``trace_train_<arch>``, TRAIN_ARCH_TRACED: where the scan's
     backward spends its time). The archs' shapes are timed too: of each arch run's recorded launches, each
     kernel's decode shape and its largest per type and epilogue
     (cr_spline: ``glu_2d`` beside two ``torch.matmul`` calls, cuBLAS
     warmed first; ``elementwise_2d`` beside a copy; Mamba's f32 softplus
     and silu among them), glu_2d at the train runs' FFN shapes
     (TRAIN_GLU_TIMED, M = 1024), and the f32 glu_2d (``tma_f32``) at
     qwen3-0.6b's full-width FFN at every ROWS_TIMED row count, beside
     two f32 cuBLAS GEMMs with TF32 off (GLU_F32_TIMED); the
     ``glu_f32_aims`` line sets every f32 glu_2d time against its
     library yardstick and its bound, the ``glu_bf16_aims`` line every
     bf16 glu_2d time at M >= 512 (qwen3's train rows under each scheme,
     TRAIN_GLU_TIMED, the sharded rank's shape; ``tma_wgmma_gemm`` at K up
     to 2048, ``tma_wgmma`` past it) likewise (information, not gates).
     Profiling comes after serving and training
     because a profiled process keeps paying tracing costs on every later
     launch.
  5. f32 prefill logits of every deployment on the card (kernels) against
     the CPU (plain versions) on the same weights; then
     ``train_f32_vs_cpu``: one f32 train step (batch 1, seq 32, full
     width, the first ARCH_F32_LAYERS layers) of each trained deployment
     on the card and on the CPU: loss,
     gnorm and the gradients of the FFN stacks and the act leaf (per knot:
     ``knot_grad``) within 1e-4 relative. The same for each ``*_fixed``
     deployment's logits at FIXED_LOGITS_TOL and ``cr_fixed``'s step at
     FIXED_F32_TOL. Then the fused per-layer assignment (28 layers), and
     each arch's fused deployment (kernelized for falcon-mamba and
     musicgen, which have no gated FFN), and the MoE archs' kernelized
     ragged one, at batch 1 x 32 (qwen2-vl with patch embeddings and
     distinct t / h / w positions, musicgen [1, 32, 4]; at the depth
     ARCH_F32_LAYERS gives, else the served one):
     each kernel launched ``launches_per_forward`` times on the card,
     1e-4 relative, and the MoE top-k experts of every token identical on
     both devices (the smallest top-k margin printed). Then
     ``train_f32_vs_cpu_<arch>``: each arch train run's loss and gradient
     at f32 (batch 1 x 32, the same depths, else the train depth), card
     against CPU: the loss, the gradient's norm and every leaf's gradient
     within ``train_f32_tol`` (1e-4; PWL_F32_TOL with a pwl layer,
     FIXED_F32_TOL with a ``*_fixed`` one; a Pade leaf keeps 1e-4, a pwl /
     poly act leaf's rows are printed only). The kernelized pwl run also
     prints where the two devices' gates straddle a knot
     (``knot_crossings``) and a control that must fail PWL_F32_TOL: the
     CPU's gradient under a backward taking the next segment's slope.
  6. the ``{"kernels": [...]}`` line: one entry per (kernel, scheme), its
     top-level times at decode and ``by_rows`` at every timed row count;
     ``elementwise_2d``'s entries add ``copy_ms``, ``glu_2d``'s the
     ``variant`` its decode launch took; the trained deployments' entries
     add ``train_launches`` (per remat run); the cr_spline entries add
     ``by_shape`` (the archs' shapes), ``arch_launches`` (the kernel's
     launches in each arch and per-layer run), ``train_arch_launches``
     (in each arch train run) and, for glu_2d, ``routed_launches``.

Every phase line carries ``t_s``, the seconds since the script started.
Then the card's ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises, exits non-zero and
prints no ok line.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

T_START = time.perf_counter()
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
# glu_2d checks of the TMA variants (bf16 tma_wgmma, f32 tma_f32): every
# decode and prefill row count the engine forms (M = 65 crosses a
# warpgroup boundary and tma_f32's 64-row tile), a ragged K and N (TMA's
# out-of-bounds fill), and N = 3001, which TMA cannot address at either
# type (wmma, simt_f32)
GLU_TMA_ROWS = (1, 2, 64, 65, 128, 256, 512, 1000, 1024)
GLU_RAGGED = ((2, 1000, 3000), (65, 1000, 3000))
GLU_UNADDRESSABLE = (3, 1024, 3001)
# each type's variants: (TMA under GLU_GEMM_ROWS rows or past
# GLU_GEMM_MAX_K, TMA from those rows up to that K, operands TMA cannot
# address); f32 has one TMA kernel at every M and K
GLU_VARIANT_OF = {"bfloat16": ("tma_wgmma", "tma_wgmma_gemm", "wmma"),
                  "float32": ("tma_f32", "tma_f32", "simt_f32")}

SLOTS, MAX_PROMPT, MAX_LEN, CHUNK = 2, 128, 160, 8
# decode steps a trace's engine takes a chunk (its profiled chunk and its
# sync check): the per-step numbers are means over the chunk's steps,
# which are alike (2 and 8 steps read the same busy ms and kernels a
# step on an H100); 8 steps (CHUNK) cost the traces 160 s more
TRACE_CHUNK = 2
GLU_PREFILL_MAX = 2 * MAX_PROMPT    # the largest ragged prefill two slots form
# training (the launcher's defaults): batch 8 x seq 128 = 1024 rows a
# kernel launch; 5 steps without remat, then 2 under remat="block"
# (remat, steps, forwards a step: "block" reruns each block's forward)
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
TRAIN_RUNS = (("none", 5, 1), ("block", 2, 2))
# decode, prefill, 2 x prefill, a training step
ROWS_TIMED = (SLOTS, MAX_PROMPT, GLU_PREFILL_MAX, TRAIN_ROWS)
# the f32 glu_2d (tma_f32) timed at qwen3-0.6b's full-width FFN (K, N) at
# every ROWS_TIMED row count, cr_spline, beside its plain version and two
# f32 cuBLAS GEMMs (TF32 off); what it is designed to reach (not gates):
# no slower than those GEMMs at every f32 shape, and at least half of the
# bound at the unsharded decode shape
GLU_F32_TIMED = tuple((rows, 1024, 3072) for rows in ROWS_TIMED)
AIM_F32_DECODE_SHARE = 0.5
# what the bf16 train-step glu_2d (tma_wgmma_gemm) is designed to reach
# (not gates): no slower than two cuBLAS GEMMs at every bf16 shape of at
# least epilogue.GLU_GEMM_ROWS rows (qwen3's train rows under each scheme,
# TRAIN_GLU_TIMED, the sharded rank's shape), and at least half of the
# bound at qwen3's train shape
AIM_BF16_TRAIN_SHARE = 0.5
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
FIXED_TRAIN_RUNS = (("none", 3, 1),)   # train_cr_fixed: 3 steps, no remat
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
# f32 gradients, card against the CPU, of a deployment with a pwl layer:
# the unit's slope jumps at every knot, so a gate value that the two
# devices' GEMMs put ~1e-7 apart on either side of a knot takes another
# slope, and the gradient of that hidden unit's column of w_gate moves
# with it. On an H100 (NVIDIA H100 80GB HBM3, 700.00 W), qwen3-0.6b fused
# and kernelized pwl read 1.29e-3 (28 layers) and 4.26e-4 (8) on w_gate
# with the loss bitwise equal; the limit is ~2.3x the worst reading. The
# kernelized pwl line prints where the two devices' gates straddle a knot
# (``knot_crossings``) and a control: the CPU's gradient under a backward
# that takes the next segment's slope must fail this limit. CR splines and
# Pade are smooth, and poly's cubic pieces meet with slopes ~1e-4 apart
# (3.5e-6 - 5.4e-6 on the H100): they keep 1e-4.
PWL_F32_TOL = 3e-3
LSB_Q213 = 2.0 ** -13
# the archs served at full width (widths never cut), each with the depth
# it is served at where the f32 masters and bf16 copies of the whole
# model would not fit one card (None: every layer): the dense and MoE
# archs, then M-RoPE (qwen2-vl), the hybrid attention + Mamba block
# (hymba), K = 4 codebook planes (musicgen) and Mamba-1 (falcon-mamba)
ARCH_RUNS = (("olmo-1b", None), ("qwen2.5-3b", None), ("yi-34b", 8),
             ("mixtral-8x22b", 2), ("llama4-scout-17b-a16e", 2),
             ("qwen2-vl-2b", None), ("hymba-1.5b", None),
             ("musicgen-large", None), ("falcon-mamba-7b", None))
# card against CPU at f32 (serve logits and train gradients), batch 1 x 32
# tokens: the MoE archs at one layer (the CPU copy ~12-17 GB), falcon-mamba
# at two (its 64 would be a 29 GB CPU copy), yi-34b at two and the others
# at four, qwen3-0.6b too (its TRAIN_ARCH_RUNS lines, the non-CR schemes
# and the per-layer runs, and phase 5's cr_spline and cr_fixed steps,
# which compared all 28 layers in 21-25 s each until the TP phase needed
# the time, then 8 until the sharded training phase did: 14-19 s each on
# a slow host): the CPU's f32 forward and backward of every layer took
# 266 s of the script's 1,070 s at the served / trained depths (an H100
# run), against a 1,200 s limit
ARCH_F32_LAYERS = {"mixtral-8x22b": 1, "llama4-scout-17b-a16e": 1,
                   "falcon-mamba-7b": 2, "yi-34b": 2, "olmo-1b": 4,
                   "qwen2.5-3b": 4, "qwen2-vl-2b": 4, "hymba-1.5b": 4,
                   "musicgen-large": 4, "qwen3-0.6b": 4}
ARCH_F32_TOKENS = 32


def served_dep(name, label=None):
    """A train run's deployment (label, config builder): the arch's
    ``arch_deployments`` entry ``name``."""
    return label or name, lambda base: dict(arch_deployments(base))[name]


def scheme_dep(kind, scheme):
    """qwen3-0.6b's ``kind`` ("fused" / "kernelized") deployment under
    ``scheme``, as phase 3 serves it: (label, config builder)."""
    def build(base):
        from repro_torch.configs.common import act_impl_of, fused_of
        if kind == "fused":
            return fused_of(act_impl_of(base, scheme))
        return act_impl_of(base, scheme, use_kernel=True)
    return f"{kind}_{scheme}", build


def per_layer_dep(name):
    """The ``per_layer_configs`` entry ``name``: (label, config
    builder)."""
    return (f"per_layer_{name}",
            lambda base: dict(per_layer_configs(base))[name])


# ROADMAP item 9b: the families trained at full width (widths never cut),
# bf16, batch 8 x seq 128 from the port's pipeline: (arch, depth, its
# deployments as (label, config builder), its runs as TRAIN_RUNS). A run
# of one deployment is named after the arch, else after the arch and the
# label. Their state (f32 weights, grads
# and two Adam moments, 16 B a param) is updated in place
# (TrainHyper(donate=True)): the functional step holds the old and the
# new state at once, 28 B a param and more. The depth is cut where state
# and activations would not fit one card (None: every layer): mixtral's
# one layer is 2.9 B params (54 GB peak on an H100); falcon-mamba's scan
# keeps ~1 GB a layer for the backward, and at 24 of its 64 layers a step
# without remat peaked at 78.9 of the card's 85 GB, so it trains at 20.
# ROADMAP item 9c adds the rest the card had not trained: olmo-1b fused
# (1.28 B params), qwen2.5-3b kernelized (3.4 B, every layer), yi-34b fused
# at 4 of 60 layers (3.15 B; 5 would be 3.71 B, 59.3 GB of state before
# activations), llama4-scout fused at 1 of 48 (4.27 B, 68.4 GB of state:
# its shared expert runs glu_2d at K = 5120), and qwen3-0.6b under the
# other three schemes, fused and kernelized, and under two per-layer
# assignments (the kernelized mix of four schemes and the float / fixed
# half-and-half).
TRAIN_ARCH_STEPS = (("none", 2, 1), ("block", 1, 2))
TRAIN_ARCH_RUNS = (
    ("qwen2-vl-2b", None, (served_dep("fused"),), TRAIN_ARCH_STEPS),
    ("hymba-1.5b", None, (served_dep("fused"),), TRAIN_ARCH_STEPS),
    ("musicgen-large", None, (served_dep("kernelized"),), TRAIN_ARCH_STEPS),
    ("falcon-mamba-7b", 20, (served_dep("kernelized"),), TRAIN_ARCH_STEPS),
    ("mixtral-8x22b", 1, (served_dep("kernelized", "gshard"),
                          served_dep("ragged")), TRAIN_ARCH_STEPS),
    ("olmo-1b", None, (served_dep("fused"),), TRAIN_ARCH_STEPS),
    ("qwen2.5-3b", None, (served_dep("kernelized"),), TRAIN_ARCH_STEPS),
    ("yi-34b", 4, (served_dep("fused"),), TRAIN_ARCH_STEPS),
    ("llama4-scout-17b-a16e", 1, (served_dep("fused"),), TRAIN_ARCH_STEPS),
    ("qwen3-0.6b", None, tuple(scheme_dep(kind, scheme)
                               for scheme in SCHEMES[1:]
                               for kind in ("fused", "kernelized"))
     + (per_layer_dep("kernelized"), per_layer_dep("float_fixed")),
     TRAIN_ARCH_STEPS))
TRAIN_ARCH_HYPER = {"donate": True}
# glu_2d at the train runs' FFN shapes (M = TRAIN_ROWS: olmo-1b, the
# qwen2.5-3b width, yi-34b, llama4-scout's shared expert), each timed
# alone in phase 4 beside its bound and two cuBLAS GEMMs
TRAIN_GLU_TIMED = ((TRAIN_ROWS, 2048, 8192), (TRAIN_ROWS, 2048, 11008),
                   (TRAIN_ROWS, 7168, 20480), (TRAIN_ROWS, 5120, 8192))
# one profiled train step of the Mamba families (where the scan's backward
# spends its time), at a cut depth: at the trained 20 / 32 layers the two
# traces took 79 s (100-171 k kernels a step), the layers being alike;
# at 5 / 8 layers 23-26 s, so 3 / 4 since the script needed the time
TRAIN_ARCH_TRACED = {"falcon-mamba-7b": 3, "hymba-1.5b": 4}
TRACE_WALL_STEPS = 3            # unprofiled steps a train trace's wall reads
# the autotuner (core/autotune.py) on the card: the reference's autotune
# arch at full width (olmo-1b: 16 layers, d 2048, bf16), trained under the
# uniform baseline (cr_fixed, depth 64) at the reference's batch 8 x seq 64
# for 40 steps, then searched over FULL_GRID (an evaluation took ~0.1 s on
# an H100, so the first sweep's 113 evaluations take ~11 s)
AUTOTUNE_ARCH = "olmo-1b"
AUTOTUNE_STEPS, AUTOTUNE_BATCH, AUTOTUNE_SEQ = 40, 8, 64
# the tuned assignment's f32 eval loss, card against CPU (relative): read
# 0.0, 3.4e-7 and 5.1e-7 on an H100 (NVIDIA H100 80GB HBM3, 700.00 W) over
# three tuned assignments; the limit is ~4x the worst, and under what one
# layer's unit moves the loss on average (all 16 layers from cr_fixed-d64
# to pwl_fixed-d32 moved it 5.7e-5 relative, ~3.6e-6 a layer)
AUTOTUNE_F32_TOL = 2e-6
# the examples/torch_*.py run in-process on the card (--device added):
# (example, argv); the second train_lm run is the first's command again,
# which resumes from its checkpoint
EXAMPLE_RUNS = (("torch_quickstart", []),
                ("torch_train_lm", ["--preset", "100m", "--steps", "10"]),
                ("torch_train_lm", ["--preset", "100m", "--steps", "10"]),
                ("torch_serve_spline_lm", []),
                ("torch_activation_ablation", ["--method", "all",
                                               "--steps", "8"]))
# roofline_calibration (ROADMAP item 13): the dry run's counts of qwen3's
# train step (TRAIN_BATCH x TRAIN_SEQ) and of one decode chunk (CHUNK
# steps, SLOTS rows, the slot cache), on the card's tensors and on meta
# tensors; the wall is the median of CALIB_WALL_STEPS unprofiled steps
CALIB_WALL_STEPS = 3
# the meta count's step peak (the dry run's temp + outputs) against the
# card's max_memory_allocated() over the step, relative: the limit set in
# PERF.md before the first card run (the same storages, the caching
# allocator's 512-byte rounding and nothing else expected; read -2.8e-7
# on an H100)
CALIB_MEM_TOL = 0.10
# the dry-run CLI in subprocesses on the card's host (its torch): every
# cell of DRYRUN_OK must report ok
DRYRUN_CLI = (["--arch", "qwen3-0.6b", "--mesh", "single"],
              ["--arch", "mixtral-8x22b", "--shape", "decode_32k",
               "--mesh", "multi"])
DRYRUN_OK = (("qwen3-0.6b", "train_4k", "single"),
             ("qwen3-0.6b", "prefill_32k", "single"),
             ("qwen3-0.6b", "decode_32k", "single"),
             ("mixtral-8x22b", "decode_32k", "multi"))
DRYRUN_TAG = "chip_smoke"


def emit(obj) -> None:
    """One JSON line; a phase line also gets ``t_s``, the seconds since the
    script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def zero_launches(epi) -> None:
    """Every kernel's launch count and every glu_2d variant's to 0."""
    for counts in (epi.LAUNCHES, epi.GLU_VARIANTS):
        for k in counts:
            counts[k] = 0


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


FLUSH_NAMES: set = set()


def flush_kernel_names(flush) -> set:
    """The names of the device kernels of ``flush.zero_()``, from a trace
    of the flush alone, taken again (at most SESSIONS times) while the
    trace comes back empty, and kept once found. A lost trace left the set
    empty and every ``device_ms`` counted the flush (~20 us for 64 MB) into
    the call's time: seen in whole-script runs on an H100, where a decode
    glu_2d read 0.029-0.035 ms against 0.010-0.016 ms in other runs."""
    global FLUSH_NAMES
    for _ in range(SESSIONS):
        if FLUSH_NAMES:
            break
        FLUSH_NAMES = {n for n, _ in device_events(flush.zero_, 3)}
    return FLUSH_NAMES


def device_ms(fn, flush, iters: int = 30, outliers: bool = False):
    """(ms, retakes): the mean device time of one call, the sum of its
    kernels' (and copies') durations in a profiler trace, L2 flushed
    before each call (the flush's own kernels are left out by name), and
    how many traces were taken again. A trace that holds none of the
    call's device activity is taken again, for every caller. With
    ``outliers`` (the copy yardstick only, whose lone-copy traces were seen
    to hold one event 16x the rest) so is a trace whose longest event
    lasts over 5x the median. At most SESSIONS traces; ms is None if none
    passed, or if no trace of the flush alone held its kernels (then
    nothing could tell them from the call's)."""
    flush_names = flush_kernel_names(flush)
    if not flush_names:
        return None, SESSIONS
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


def tma_variant(epi, dtype, m, k) -> str:
    """The TMA variant a glu_2d launch of ``m`` rows, ``k`` K rows and type
    ``dtype`` (its name, "bfloat16" / "float32") takes: bf16 from
    ``epilogue.GLU_GEMM_ROWS`` (512) rows at K up to
    ``epilogue.GLU_GEMM_MAX_K`` (2048) on the GEMM tile, else the served
    kernel."""
    below, above, _ = GLU_VARIANT_OF[dtype]
    return above if m >= epi.GLU_GEMM_ROWS and k <= epi.GLU_GEMM_MAX_K \
        else below


def glu_variant_tally(epi, shapes):
    """The glu_2d launches by variant that ``shapes`` (ShapeLog's record
    of a run) should count, each launch on the TMA variant of its type and
    rows, and the recorded launches that took another: (tally,
    mismatches)."""
    want, off = {v: 0 for v in epi.GLU_VARIANTS}, []
    for (kernel, shape, dtype, act, variant), n in shapes.items():
        if kernel != "glu_2d":
            continue
        tma = tma_variant(epi, dtype, shape[0], shape[1])
        want[tma] += n
        if variant != tma:
            off.append((list(shape), dtype, variant, tma))
    return want, off


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

    # each type's TMA variant at every row count, ragged K and N, and its
    # variant for operands TMA cannot address, for every scheme and
    # epilogue; each launch repeated for bitwise determinism
    cases = [(M, K, N) for M in GLU_TMA_ROWS] + list(GLU_RAGGED)
    # the served rows (at most GLU_PREFILL_MAX) stay on tma_wgmma, 512,
    # 1000 and 1024 take tma_wgmma_gemm
    assert GLU_PREFILL_MAX < epi.GLU_GEMM_ROWS <= 512, epi.GLU_GEMM_ROWS
    for dtype, (_, _, other) in GLU_VARIANT_OF.items():
        dt = getattr(torch, dtype)
        for scheme in SCHEMES:
            for act in acts_of(epi, scheme):
                spec, p = scheme_spec(torch, epi, scheme, act, dev)
                errs, variants = {}, {}
                for shape in cases + [GLU_UNADDRESSABLE]:
                    variant = other if shape == GLU_UNADDRESSABLE \
                        else tma_variant(epi, dtype, *shape[:2])
                    key = f"{list(shape)}"
                    errs[key] = check_glu_variant(
                        torch, epi, spec, p, act,
                        *glu_operands(torch, gen, dev, *shape, dt), variant)
                    variants[key] = variant
                worst["glu_2d", scheme] = max(worst["glu_2d", scheme],
                                              *errs.values())
                emit({"phase": "kernel_check_glu_variants",
                      "scheme": scheme, "act": act, "dtype": dtype,
                      "deterministic": True, "variant": variants,
                      "max_abs_err": errs})

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


class ShapeLog:
    """Records, while active, every launch the two kernel wrappers make,
    by (kernel, shape, dtype, act, variant): ``shape`` is [rows, cols] for
    elementwise_2d and [M, K, N] for glu_2d, ``variant`` the glu_2d
    variant the launch took (None for elementwise_2d). A call that
    launches nothing (a zero-row tensor) is not recorded. The model
    reaches both wrappers through the module (``ops`` calls
    ``epi.<kernel>``), so wrapping the module's names sees every launch."""

    def __init__(self, epi):
        self.epi, self.shapes = epi, {}

    def __enter__(self):
        epi = self.epi
        self.orig = {k: getattr(epi, k) for k in REPLACES}

        def wrap(kernel, fn):
            def call(*args, **kw):
                n0, v0 = epi.LAUNCHES[kernel], dict(epi.GLU_VARIANTS)
                y = fn(*args, **kw)
                if epi.LAUNCHES[kernel] != n0:
                    x = args[0]
                    shape = tuple(x.shape) + ((args[1].shape[1],)
                                              if kernel == "glu_2d" else ())
                    variant = next((v for v in v0 if epi.GLU_VARIANTS[v]
                                    != v0[v]), None)
                    key = (kernel, shape, str(x.dtype).removeprefix("torch."),
                           kw["act"], variant)
                    self.shapes[key] = self.shapes.get(key, 0) + 1
                return y
            return call

        for k, fn in self.orig.items():
            setattr(epi, k, wrap(k, fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.epi, k, fn)


# every distinct launch of the counted served runs (``drive``) and train
# runs (``phase_train``), as ShapeLog keys them, with its number of launches
SERVED_SHAPES: dict = {}


def phase_kernel_checks_served(torch, epi, dev, worst):
    """Both kernels at every distinct shape the counted served and train
    runs of phase 3 launched them at (SERVED_SHAPES: every deployment,
    cache, type and arch served or trained), for every scheme, on random
    inputs of that shape and type: phase 2's tolerances, the variant the
    launch took (glu_2d), and a repeated launch bit-identical. Updates
    ``worst``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    specs = {}
    cases = {k: [] for k in REPLACES}
    for (kernel, shape, dtype, act, variant), n in sorted(
            SERVED_SHAPES.items(), key=lambda kv: repr(kv[0])):
        dt = getattr(torch, dtype)
        if kernel == "glu_2d":
            inputs = glu_operands(torch, gen, dev, *shape, dt)
        else:
            inputs = ((torch.randn(shape, generator=gen, device=dev)
                       * 3).to(dt),)
        errs = {}
        for scheme in SCHEMES:
            if (scheme, act) == ("rational", "softplus"):
                continue
            if (scheme, act) not in specs:
                specs[scheme, act] = scheme_spec(torch, epi, scheme, act, dev)
            spec, p = specs[scheme, act]
            if kernel == "glu_2d":
                errs[scheme] = check_glu_variant(torch, epi, spec, p, act,
                                                 *inputs, variant)
            else:
                errs[scheme] = check_elementwise(torch, epi, spec, p, act,
                                                 *inputs)
                y1 = epi.elementwise_2d(*inputs, p, spec=spec, act=act)
                y2 = epi.elementwise_2d(*inputs, p, spec=spec, act=act)
                assert torch.equal(y1, y2), ("elementwise_2d not "
                                             "deterministic", shape, dtype)
            worst[kernel, scheme] = max(worst[kernel, scheme], errs[scheme])
        del inputs
        cases[kernel].append({"shape": list(shape), "dtype": dtype,
                              "act": act, "variant": variant,
                              "served_launches": n, "max_abs_err": errs})
    for kernel, got in cases.items():
        emit({"phase": "kernel_check_served_shapes", "kernel": kernel,
              "schemes": list(SCHEMES), "deterministic": True,
              "shapes": len(got), "cases": got})
    assert all(cases.values()), {k: len(v) for k, v in cases.items()}


def phase_grouped_mm(torch, dev):
    """The ragged MoE path's grouped GEMM (``torch._grouped_mm``, the
    counterpart of the reference's ragged_dot) on the card: which operand
    types it takes, each against a loop over the groups in f32 (an empty
    group included), and no host sync at bf16."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    sizes = torch.tensor([11, 0, 20, 9], device=dev)
    offs = torch.cumsum(sizes, dim=0).to(torch.int32)
    x = torch.randn((40, 64), generator=gen, device=dev)
    w = torch.randn((4, 64, 128), generator=gen, device=dev)
    bounds = [0, 11, 11, 31, 40]
    ref = torch.cat([x[bounds[j]:bounds[j + 1]] @ w[j] for j in range(4)])
    took = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        try:
            y = torch._grouped_mm(x.to(dt), w.to(dt), offs=offs)
        except RuntimeError as e:
            took[str(dt)] = f"refused: {str(e)[:200]}"
            continue
        took[str(dt)] = float((y.float() - ref).abs().max()
                              / ref.abs().max())
    xb, wb = x.bfloat16(), w.bfloat16()
    torch.cuda.synchronize()
    syncs = host_syncs(torch, lambda: torch._grouped_mm(
        xb, wb, offs=torch.cumsum(sizes, dim=0).to(torch.int32)))
    emit({"phase": "grouped_mm", "torch": torch.__version__,
          "rel_err_vs_group_loop": took, "bf16_host_syncs": syncs})
    # the served ragged path runs bf16, its f32 card-vs-CPU check f32
    for dt, tol in (("torch.float32", 1e-6), ("torch.bfloat16", 2e-2)):
        assert isinstance(took[dt], float) and took[dt] <= tol, took
    assert syncs == 0, syncs


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


def phase_kernel_times(torch, epi, dev, flush, arch_lines):
    """Kernel, plain version and library yardstick at the main path's
    shapes (bf16), for every scheme on the same inputs: decode rows =
    SLOTS, the longest prefill (one 128-token bucket) and GLU_PREFILL_MAX
    rows; elementwise_2d beside a copy of the same bytes; then the archs'
    shapes (``arch_time_cases``). All per-call
    event times are taken before the first profiler session: a profiled
    process keeps paying per-launch tracing costs afterwards. main() has
    turned TF32 off, so the f32 library yardstick is two full f32 GEMMs,
    as the f32 kernel never uses TF32."""
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
                            epi.epilogue_ops(spec, p) * x.numel(),
                            F32_FLOPS),
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
    cases.update(arch_time_cases(torch, epi, dev, gen, arch_lines))
    # cuBLAS picks and loads its GEMM kernels on a shape's first call: warm
    # every library yardstick before the first one is timed
    for c in cases.values():
        if "library" in c["fns"]:
            for _ in range(3):
                c["fns"]["library"]()
    torch.cuda.synchronize()
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
        f32 = got.dtype == torch.float32
        if key[0] == "glu_2d":
            torch.testing.assert_close(got.float(), plain.float(),
                                       rtol=1e-4 if f32 else 1e-2,
                                       atol=1e-5 if f32 else 1e-3)
        elif f32:
            torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)
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
        t = dict(shape=c["shape"], dtype=c.get("dtype", "bfloat16"),
                 max_abs_err=err,
                 ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                 bound_ms=c["bound"][0], bound_by=c["bound"][1],
                 library_ms=dev_ms.get("library"), timing=how,
                 call_ms=calls[(key, "kernel")],
                 plain_call_ms=calls[(key, "plain")],
                 library_call_ms=calls.get((key, "library")), **extra)
        timings[key] = t
        where = c.get("where") or {SLOTS: "decode", TRAIN_ROWS: "train"}.get(
            key[2], "prefill")
        emit({"phase": "kernel_time", "kernel": key[0], "scheme": key[1],
              "where": where, "rows": c["shape"][0], **t})
    return timings


def arch_time_cases(torch, epi, dev, gen, arch_lines):
    """phase_kernel_times' cases at the archs' shapes, under cr_spline (the
    scheme they serve): of each arch run's launches (``kernel_shapes`` of
    its serve line), for each kernel, type and epilogue, the decode shape
    (fewest rows) and the largest, glu_2d at TRAIN_GLU_TIMED and the f32
    glu_2d at GLU_F32_TIMED; glu_2d beside two torch.matmul calls,
    elementwise_2d beside a copy. Keyed
    (kernel, "cr_spline", "MxKxN" or "RxC"), the name suffixed
    ":<dtype>:<act>" unless bf16 silu."""
    picked = {}
    for line in arch_lines.values():
        groups = {}
        for k, shape, dt, act, _ in line["kernel_shapes"]:
            groups.setdefault((k, dt, act), []).append(tuple(shape))
        for (kernel, dt, act), got in groups.items():
            got.sort()
            picked.setdefault((kernel, got[0], dt, act), "decode")
            picked.setdefault((kernel, got[-1], dt, act), "prefill")
    for shape in TRAIN_GLU_TIMED:
        picked.setdefault(("glu_2d", shape, "bfloat16", "silu"), "train")
    for shape in GLU_F32_TIMED:
        picked.setdefault(("glu_2d", shape, "float32", "silu"), {
            SLOTS: "decode", TRAIN_ROWS: "train"}.get(shape[0], "prefill"))
    cases = {}
    for (kernel, shape, dt, act), where in sorted(picked.items()):
        name = "x".join(map(str, shape))
        if (dt, act) != ("bfloat16", "silu"):
            name += f":{dt}:{act}"
        spec, p = scheme_spec(torch, epi, "cr_spline", act, dev)
        dtype = getattr(torch, dt)
        if kernel == "glu_2d":
            rows, K, N = shape
            a = glu_operands(torch, gen, dev, rows, K, N, dtype)
            nbytes = (rows * K + 2 * K * N + rows * N) * a[0].element_size() \
                + p.numel() * 4
            cases[("glu_2d", "cr_spline", name)] = dict(
                shape=list(shape), dtype=dt, extra={}, where=where,
                bound=bound(nbytes, 4.0 * rows * N * K, BF16_TC_FLOPS
                            if dt == "bfloat16" else F32_FLOPS),
                fns={"kernel": lambda a=a, s=spec, p=p, act=act: epi.glu_2d(
                         *a, p, spec=s, act=act),
                     "plain": lambda a=a, s=spec, p=p, act=act:
                         epi.glu_2d_plain(*a, p, spec=s, act=act),
                     "library": lambda a=a: (torch.matmul(a[0], a[1]),
                                             torch.matmul(a[0], a[2]))})
            continue
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        y = torch.empty_like(x)
        cases[("elementwise_2d", "cr_spline", name)] = dict(
            shape=list(shape), dtype=dt, where=where,
            extra=dict(act=act, geometry=list(epi._elementwise_geometry(
                *shape, x.dtype))),
            bound=bound(2 * x.numel() * x.element_size() + p.numel() * 4,
                        epi.epilogue_ops(spec, p, act) * x.numel(),
                        F32_FLOPS),
            fns={"kernel": lambda x=x, s=spec, p=p, act=act:
                     epi.elementwise_2d(x, p, spec=s, act=act),
                 "plain": lambda x=x, s=spec, p=p, act=act:
                     epi.elementwise_2d_plain(x, p, spec=s, act=act),
                 "copy": lambda x=x, y=y: y.copy_(x)})
    return cases


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


def f32_glu_variants(epi, before, block) -> None:
    """The glu_2d launches of an f32 block (phase 5: the card side of every
    f32 comparison with the CPU) since ``before``, by variant: all on
    tma_f32, whose operands the f32 path always gives TMA-addressable."""
    got = {v: epi.GLU_VARIANTS[v] - before[v] for v in before}
    emit({"phase": "f32_glu_variants", "block": block, "glu_variants": got})
    assert got["tma_f32"] > 0 and got["tma_f32"] == sum(got.values()), got


def glu_f32_aims(timings, seconds, tf32) -> None:
    """The f32 glu_2d's design aims, from this run's timings of every f32
    glu_2d shape (GLU_F32_TIMED and the archs' f32 launches): ``ms`` over
    ``library_ms`` (two f32 cuBLAS GEMMs; aim: at most 1; ``library_tf32``
    is the TF32 setting they ran under, which main() turns off) and the
    share of the bound (``bound_ms`` / ``ms``; aim at the unsharded
    decode shape: AIM_F32_DECODE_SHARE). Information, not a gate. Also
    the kernel-timing phase's seconds."""
    rows = {}
    for key, t in timings.items():
        if key[0] != "glu_2d" or t["dtype"] != "float32":
            continue
        rows["x".join(map(str, t["shape"]))] = {
            "variant": t["variant"], "ms": t["ms"],
            "library_ms": t["library_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "ms_over_library_ms": t["ms"] / t["library_ms"],
            "bound_share": t["bound_ms"] / t["ms"],
            "library_met": t["ms"] <= t["library_ms"]}
    decode = rows.get("x".join(map(str, GLU_F32_TIMED[0])))
    emit({"phase": "glu_f32_aims", "library_tf32": tf32, "shapes": rows,
          "aim_decode_bound_share": AIM_F32_DECODE_SHARE,
          "decode_share_met": bool(decode) and decode["bound_share"]
          >= AIM_F32_DECODE_SHARE,
          "library_met_everywhere": all(r["library_met"]
                                        for r in rows.values()),
          "kernel_times_s": seconds})


def glu_bf16_aims(epi, timings) -> None:
    """The bf16 train-step glu_2d's design aims, from this run's timings of
    every bf16 glu_2d shape of at least ``epi.GLU_GEMM_ROWS`` rows: ``ms`` over
    ``library_ms`` (two cuBLAS GEMMs; aim: at most 1) and the share of the
    bound (``bound_ms`` / ``ms``; aim at qwen3's train shape, M = K = 1024,
    N = 3072, under cr_spline: AIM_BF16_TRAIN_SHARE), with the variant each
    took. Information, not a gate."""
    rows = {}
    for key, t in timings.items():
        if (key[0] != "glu_2d" or t["dtype"] != "bfloat16"
                or t["shape"][0] < epi.GLU_GEMM_ROWS):
            continue
        name = "x".join(map(str, t["shape"]))
        if key[1] != "cr_spline":
            name += f":{key[1]}"
        rows[name] = {
            "variant": t["variant"], "ms": t["ms"],
            "library_ms": t["library_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "ms_over_library_ms": t["ms"] / t["library_ms"],
            "bound_share": t["bound_ms"] / t["ms"],
            "library_met": t["ms"] <= t["library_ms"]}
    train = rows.get("x".join(map(str, (TRAIN_ROWS, 1024, 3072))))
    emit({"phase": "glu_bf16_aims", "shapes": rows,
          "aim_train_bound_share": AIM_BF16_TRAIN_SHARE,
          "train_share_met": bool(train) and train["bound_share"]
          >= AIM_BF16_TRAIN_SHARE,
          "library_met_everywhere": all(r["library_met"]
                                        for r in rows.values())})


def serve(torch, cfg, params, prompts, dev, max_new=MAX_NEW, mesh=None,
          **ecfg):
    from repro_torch.serve import EngineConfig, ServeEngine
    ecfg = EngineConfig(slots=SLOTS, max_prompt_len=MAX_PROMPT,
                        max_len=MAX_LEN, chunk=CHUNK, page_size=PAGE_SIZE,
                        **ecfg)
    eng = ServeEngine(cfg, params, ecfg, mesh=mesh, device=dev)
    for pr in prompts:
        eng.submit(pr, max_new=max_new)
    done = eng.run()
    return done, eng


Served = collections.namedtuple("Served", "toks eng launches variants "
                                            "shapes")


def drive(torch, epi, cfg, params, prompts, dev, mesh=None, **ecfg):
    """One served run (this rank's part of it with ``mesh``) with the
    launch counts zeroed just before and read just after. Each kernel must launch exactly launches_per_forward(cfg)
    x forwards times (forwards: prefill batches + prefill chunks + decode
    steps, from the run's EngineStats), every glu_2d launch on the TMA
    variant of its type and rows (``glu_variant_tally``: tma_wgmma at
    bf16, every served launch having at most 256 rows; tma_f32 at f32),
    the counts by variant exact; every request
    completes with MAX_NEW tokens and every page comes back. Each launch's
    shape goes into SERVED_SHAPES. Returns a Served."""
    zero_launches(epi)
    with ShapeLog(epi) as log:
        done, eng = serve(torch, cfg, params, prompts, dev, mesh=mesh,
                          **ecfg)
    launches = dict(epi.LAUNCHES)
    variants = dict(epi.GLU_VARIANTS)
    st = eng.stats
    forwards = st.prefill_batches + st.prefill_chunks + st.decode_steps
    want = {k: n * forwards for k, n in launches_per_forward(cfg).items()}
    assert launches == want, (cfg.name, launches, want, forwards)
    want_variants, off = glu_variant_tally(epi, log.shapes)
    assert not off and variants == want_variants, (variants, off)
    assert sum(variants.values()) == launches["glu_2d"], variants
    assert len(done) == len(prompts), done
    K = cfg.n_codebooks
    for c in done:
        assert len(c.tokens) == MAX_NEW and c.finish_reason == "length", c
        ids = [x for t in c.tokens for x in (t if K > 1 else (t,))]
        assert len(ids) == MAX_NEW * K, c.tokens
        assert all(0 <= t < cfg.padded_vocab for t in ids), c.tokens
    if eng.paged:
        assert eng.snapshot().pages_in_use == 0 and eng._pool.reserved == 0
    for key, n in log.shapes.items():
        SERVED_SHAPES[key] = SERVED_SHAPES.get(key, 0) + n
    return Served([c.tokens for c in done], eng, launches, variants,
                  log.shapes)


def agreement(a, b) -> float:
    return sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb)) \
        / sum(map(len, a))


def phase_serve(torch, epi, name, cfg, params, prompts, dev, card,
                cache="paged", engine_kw=None, **extra):
    """Warm up (every prompt, 2 tokens: every prefill bucket and insert
    shape once), then drive the main path on ``cache`` (``drive``'s
    gates), ``engine_kw`` added to the EngineConfig. Emits the run's
    line, with ``extra``, the contract the engine took (paged, prefix
    sharing, chunked prefill) and the peak device memory of the counted
    run, and returns (tokens, launches, line)."""
    engine_kw = engine_kw or {}
    serve(torch, cfg, params, prompts, dev, max_new=2, cache=cache,
          **engine_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive(torch, epi, cfg, params, prompts, dev, cache=cache,
                **engine_kw)
    st, eng = run.eng.stats, run.eng
    line = {"phase": name if cache == "paged" else f"{name}_slot",
            "card": card, "arch": cfg.name, "layers": cfg.n_layers,
            "cache": cache, "requests": len(run.toks),
            "planes": cfg.n_codebooks, "engine_kw": engine_kw,
            "paged": eng.paged, "prefix_enabled": eng.prefix_enabled,
            "chunked": eng.chunked, "prefill_chunks": st.prefill_chunks,
            "prefill_batches": st.prefill_batches,
            "decode_steps": st.decode_steps, "launches": run.launches,
            "launches_per_forward": launches_per_forward(cfg),
            "glu_variants": run.variants,
            "kernel_shapes": [[k, list(shape), dt, act, n]
                              for (k, shape, dt, act, _), n in
                              sorted(run.shapes.items(), key=repr)],
            "prefill_tokens": st.prefill_tokens, "prefill_s": st.prefill_s,
            "insert_s": st.insert_s, "decode_tokens": st.decode_tokens,
            "decode_s": st.decode_s,
            "prefill_tokens_per_s": st.prefill_tokens_per_s,
            "decode_tokens_per_s": st.decode_tokens_per_s,
            "pages_peak": st.pages_peak,
            "weights_read_floor_ms": weights_read_ms(eng.params),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9, **extra}
    emit(line)
    return run.toks, run.launches, line


def weights_read_ms(params) -> float:
    """The least time a decode step can take: every weight the engine
    holds read once at HBM_BYTES_PER_S, but the embedding table (a step
    reads only its rows)."""
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for k, v in tree.items() if k != "embed")
        return tree.numel() * tree.element_size()
    return nbytes(params) / HBM_BYTES_PER_S * 1e3


def latency(done_eng):
    """TTFT and ITL p99 (ms) of each completion of an engine's run."""
    done = sorted(done_eng.completions, key=lambda c: c.uid)
    return ([c.ttft_s * 1e3 for c in done], [c.itl_p99_s * 1e3 for c in done])


def phase_prefix(torch, epi, name, cfg, params32, dev, card):
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
        run = drive(torch, epi, c, p, prompts, dev, admission="serial")
        cold = drive(torch, epi, c, p, prompts, dev, admission="serial",
                     prefix_cache=False)
        warm, eng, ceng = run.toks, run.eng, cold.eng
        st = eng.stats
        assert st.prefix_hit_tokens == hit, (st.prefix_hit_tokens, hit)
        assert ceng.stats.prefix_hit_tokens == 0
        agree = agreement(warm, cold.toks)
        if dtype == "float32":
            assert warm == cold.toks, (name, "prefix hit != cold at f32")
        out[dtype] = {"prefix_hit_tokens": st.prefix_hit_tokens,
                      "prefix_hit_rate": st.prefix_hit_rate,
                      "prefill_tokens": st.prefill_tokens,
                      "cold_prefill_tokens": ceng.stats.prefill_tokens,
                      "launches": run.launches,
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
                  one_shot_bf16):
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
        run = drive(torch, epi, c, p, prompts, dev,
                    chunk_prefill=CHUNK_PREFILL)
        got, eng = run.toks, run.eng
        st = eng.stats
        assert st.prefill_chunks > 0, st
        if dtype == "float32":
            base = drive(torch, epi, c, p, prompts, dev).toks
            assert got == base, (name, "chunked != one-shot at f32")
        else:
            base = one_shot_bf16
        ttft, itl = latency(eng)
        out[dtype] = {"prefill_chunks": st.prefill_chunks,
                      "decode_steps": st.decode_steps,
                      "launches": run.launches,
                      "decode_tokens_per_s": st.decode_tokens_per_s,
                      "ttft_ms": ttft, "itl_p99_ms": itl,
                      "token_agreement_vs_one_shot": agreement(got, base)}
        del p
    emit(out)


def decode_chunk_sync_check(torch, cfg, eng, steps=CHUNK):
    """One decode chunk of ``steps`` steps of ``eng`` (requests admitted;
    with its write mask when paged) under CUDA's sync debug mode "error".
    A decode chunk enqueues all its steps without one host sync: any sync
    inside (a copy from host memory, .item(), ...) raises here."""
    from repro_torch.serve.engine import make_decode_chunk
    chunk = make_decode_chunk(cfg, steps, paged=eng.paged)
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk(eng.params, eng.cache, eng.state, 0, [0] * SLOTS,
              [0] * SLOTS, [0.0] * SLOTS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_trace(torch, name, cfg, params, prompts, dev, serve_line, cache):
    """Where a decode step's time goes: one decode chunk (TRACE_CHUNK
    steps) of the same engine under the profiler (device activity only).
    Device busy time
    per step against the unprofiled wall time per step of the main run
    gives the device's idle share; the repro kernels' share is the FFN
    kernel's part; ``top_kernels`` names the TOP_KERNELS device kernels
    with the most time a step. Then one more decode chunk (with its write
    mask when paged) under CUDA's sync debug mode, which fails the run if
    the chunk makes the host wait."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import EngineConfig, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(
        slots=SLOTS, max_prompt_len=MAX_PROMPT, max_len=MAX_LEN,
        chunk=TRACE_CHUNK, page_size=PAGE_SIZE, cache=cache), device=dev)
    for pr in prompts[:SLOTS]:
        eng.submit(pr, max_new=MAX_NEW)
    eng.step()                          # admission + first decode chunk
    steps0 = eng.stats.decode_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step()                      # one decode chunk, ends at a sync
    steps = eng.stats.decode_steps - steps0
    decode_chunk_sync_check(torch, cfg, eng, TRACE_CHUNK)
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


SYNC_WARNING = "called a synchronizing CUDA operation"


def host_syncs(torch, fn) -> int:
    """How many times ``fn`` made the host wait for the device, as CUDA's
    sync debug mode reports them (one warning each): those raised as
    Python warnings, and those a thread without Python (a collective's
    worker) writes to the stderr file, which is caught here."""
    import os
    import tempfile
    import warnings
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile(mode="w+") as err:
        os.dup2(err.fileno(), 2)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        finally:
            os.dup2(saved, 2)
            os.close(saved)
        err.seek(0)
        threads = err.read().count(SYNC_WARNING)
    # the mode's own notice ("Synchronization debug mode is a prototype
    # ...") is not a sync
    return threads + sum(SYNC_WARNING in str(w.message) for w in caught)


def phase_train(torch, epi, name, cfg, weights, dev, card, runs=TRAIN_RUNS,
                hyper=None, **extra):
    """Train at full width through the port's TrainDriver and pipeline:
    ``runs`` (TRAIN_RUNS: 5 steps without remat, then 2 under
    remat="block", continuing the same run), each with the launch counts
    zeroed just before and read just after. Each kernel must launch
    exactly launches_per_forward(cfg) x forwards a step x steps times
    (a step is one forward without remat and two under "block", whose
    checkpoint reruns each block's forward in the backward; the
    recompute backward of the kernels launches none), every glu_2d
    launch on the TMA variant of its type and shape
    (``glu_variant_tally``: bf16 tma_wgmma_gemm at the step's 1024 rows
    and K up to 2048, tma_wgmma past that K; f32 tma_f32), the counts by
    variant exact; every loss finite, nothing skipped. ``hyper``
    adds TrainHyper fields (``donate`` for a model whose state fills the
    card: then the steps update ``weights``' tensors in place). Then one
    more step under CUDA's sync debug mode must make no host sync.
    Emits and returns the line, with ``extra``."""
    import tempfile
    from repro_torch.ft import FTConfig, TrainDriver
    from repro_torch.launch import steps as TS
    from repro_torch.optim import adamw
    hyper = hyper or {}
    params = with_act(torch, weights, cfg, dev)
    opt = adamw.init_state(params)
    pipe = train_pipe(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    per_fwd = launches_per_forward(cfg)
    line = {"phase": "train_" + name, "card": card, "arch": cfg.name,
            "layers": cfg.n_layers, "vocab": cfg.vocab_size,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "planes": cfg.n_codebooks, "compute_dtype": cfg.compute_dtype,
            "scheme": train_scheme(cfg),
            "moe_impl": cfg.moe_impl if cfg.n_experts else None,
            "hyper": hyper, "launches_per_forward": per_fwd, **extra,
            "runs": {}}
    step = 0
    with tempfile.TemporaryDirectory() as ckpt:
        ft = FTConfig(ckpt_dir=ckpt, ckpt_every=10 ** 9, log_every=0)
        for remat, n_steps, fwd in runs:
            step_fn = TS.make_train_step(cfg, TS.TrainHyper(
                remat=remat, opt=train_opt(), **hyper))
            drv = TrainDriver(step_fn, pipe, params, opt, ft,
                              start_step=step, log=lambda *_: None)
            del params, opt
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches(epi)
            with ShapeLog(epi) as log:
                drv.run(n_steps)
            for key, n in log.shapes.items():
                SERVED_SHAPES[key] = SERVED_SHAPES.get(key, 0) + n
            launches = dict(epi.LAUNCHES)
            variants = dict(epi.GLU_VARIANTS)
            peak = torch.cuda.max_memory_allocated()
            recs = drv.history
            assert [r.step for r in recs] == list(range(step, step + n_steps))
            assert all(math.isfinite(r.loss) and not r.skipped
                       for r in recs), \
                [(r.loss, r.skipped) for r in recs]
            want = {k: n * fwd * n_steps for k, n in per_fwd.items()}
            assert launches == want, (name, remat, launches, want)
            want_variants, off = glu_variant_tally(epi, log.shapes)
            assert not off and variants == want_variants, (variants, off)
            assert sum(variants.values()) == launches["glu_2d"], variants
            walls = [r.wall_s * 1e3 for r in recs]
            steady = statistics.median(walls[1:] if len(walls) > 1
                                       else walls)
            line["runs"][remat] = {
                "steps": n_steps, "first_step": step,
                "losses": [r.loss for r in recs],
                "gnorms": [r.gnorm for r in recs],
                "skipped": sum(r.skipped for r in recs),
                "launches": launches, "glu_variants": variants,
                "launches_per_step": {k: n / n_steps
                                      for k, n in launches.items()},
                "step_wall_ms": walls, "step_wall_ms_median": steady,
                "train_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
                "max_memory_allocated_gb": peak / 1e9}
            params, opt, step = drv.params, drv.opt_state, drv.step
            del drv
        step_fn = TS.make_train_step(cfg, TS.TrainHyper(
            remat=runs[0][0], opt=train_opt(), **hyper))
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


def phase_train_trace(torch, name, cfg, weights, dev, train_line,
                      hyper=None):
    """Where a train step's time goes: one step (the train line's first
    remat) under the profiler, after a warm step and TRACE_WALL_STEPS
    unprofiled steps whose median wall time it is held against (the same
    depth, which may be cut below the train run's): device busy ms, idle
    share, kernels per step and the top kernels with their launches.
    ``hyper`` as phase_train's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps as TS
    from repro_torch.optim import adamw
    params = with_act(torch, weights, cfg, dev)
    opt = adamw.init_state(params)
    batch = train_pipe(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)(0)
    remat = next(iter(train_line["runs"]))
    step_fn = TS.make_train_step(cfg, TS.TrainHyper(remat=remat,
                                                    opt=train_opt(),
                                                    **(hyper or {})))
    params, opt, m = step_fn(params, opt, batch, 1)
    float(m["loss"])
    walls = []
    for step in range(2, 2 + TRACE_WALL_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, step)
        float(m["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, m = step_fn(params, opt, batch, 2 + TRACE_WALL_STEPS)
        float(m["loss"])
    evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(us for _, us in evs) / 1e3
    by_name = {}
    for n, us in evs:
        t, k = by_name.get(n, (0.0, 0))
        by_name[n] = (t + us, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    emit({"phase": "trace_train_" + name, "remat": remat,
          "layers": cfg.n_layers, "train_layers": train_line["layers"],
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


def launches_per_forward(cfg) -> dict:
    """Launches of each kernel in one forward of ``cfg``, derived from the
    block's code (``models/layers.py``, as the reference's): on a layer
    whose engine is kernelized (``use_kernel`` and an approximant scheme)
    every engine nonlinearity is one elementwise_2d launch. A dense FFN,
    or an MoE layer's shared expert, is one glu_2d launch under
    ``fuse_mlp`` (any approximant engine) and else one engine activation.
    The routed experts' activation always goes through the engine: one
    call per top-k slot under gshard, one under ragged. A Mamba branch
    (falcon-mamba's every layer, hymba's beside attention) makes three
    engine calls: silu of the conv, softplus of dt, silu of the gate z.
    A ``*_fixed`` layer launches nothing."""
    from repro_torch.core.activations import scheme_of
    out = {"glu_2d": 0, "elementwise_2d": 0}
    dense = cfg.has_ffn and (cfg.n_experts == 0 or cfg.shared_expert)
    mamba = cfg.use_mamba or cfg.parallel_mamba
    for c in cfg.layer_activation_configs():
        kernelized = c.use_kernel and scheme_of(c.impl) is not None
        if dense and cfg.fuse_mlp:
            out["glu_2d"] += 1
        elif dense and kernelized:
            out["elementwise_2d"] += 1
        if cfg.n_experts and kernelized:
            out["elementwise_2d"] += (cfg.top_k if cfg.moe_impl == "gshard"
                                      else 1)
        if mamba and kernelized:
            out["elementwise_2d"] += 3
    return out


def arch_prompts(np, cfg):
    """PERF.md's schedule: 4 prompts of PROMPT_LENS tokens from seed 0
    over the arch's vocabulary ([n, K] for K codebook planes)."""
    rng = np.random.RandomState(0)
    planes = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return [rng.randint(0, cfg.vocab_size, (n,) + planes).astype(np.int32)
            for n in PROMPT_LENS]


def arch_config(registry, arch, depth):
    """(full config, served config): the served one keeps every width and
    cuts n_layers to ``depth`` (None: none cut)."""
    full = registry.get(arch)
    return full, (full if depth is None
                  else dataclasses.replace(full, n_layers=depth))


def arch_deployments(base):
    """(name, config) of each served deployment of an arch: cr_spline
    fused (glu_2d on every dense FFN and shared expert; only where there
    is a gated FFN to fuse: not falcon-mamba, not musicgen) and
    kernelized (elementwise_2d on every activation), and for MoE the
    kernelized deployment under moe_impl="ragged" (the grouped GEMM
    path)."""
    from repro_torch.configs.common import act_impl_of, fused_of
    kern = act_impl_of(base, "cr_spline", use_kernel=True)
    fused = fused_of(base)
    deps = ([("fused", fused)] if fused.fuse_mlp else []) \
        + [("kernelized", kern)]
    if base.n_experts:
        deps.append(("ragged", dataclasses.replace(kern, moe_impl="ragged")))
    return deps


def release(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_archs(torch, np, epi, registry, dev, card):
    """Serve each arch of ARCH_RUNS at full width (random weights, seed 0,
    bf16 compute, the paged cache, PERF.md's schedule) under each of its
    deployments, before any profiler session: warm-up, then the counted
    run. Each model is built, served and freed before the next. Returns
    {run name: serve line}."""
    import gc
    from repro_torch.models import model as M
    lines = {}
    for arch, depth in ARCH_RUNS:
        full, base = arch_config(registry, arch, depth)
        prompts = arch_prompts(np, base)
        weights = M.materialize_params(base, seed=0, device=dev)
        reduced = {} if depth is None else {"n_layers": [depth,
                                                         full.n_layers]}
        stateful = base.use_mamba or base.parallel_mamba
        for dep, cfg in arch_deployments(base):
            params = with_act(torch, weights, cfg, dev)
            name = f"serve_{arch}_{dep}"
            # a Mamba stack asks for chunked prefill too: the engine must
            # keep one-shot admission (and no prefix sharing), as the
            # reference's does
            _, _, line = phase_serve(
                torch, epi, name, cfg, params, prompts, dev, card,
                engine_kw={"chunk_prefill": CHUNK_PREFILL} if stateful
                else None, deployment=dep,
                moe_impl=cfg.moe_impl if cfg.n_experts else None,
                reduced=reduced, full_layers=full.n_layers,
                params_served=cfg.param_count())
            lines[name] = line
            assert line["paged"] == (cfg.has_attention
                                     or cfg.parallel_mamba), line["paged"]
            if stateful:
                assert not (line["prefix_enabled"] or line["chunked"]
                            or line["prefill_chunks"]), line
                assert line["prefill_batches"] == len(set(PROMPT_LENS)), line
            del params
            gc.collect()
        del weights
        release(torch)
    return lines


def per_layer_configs(base):
    """(name, config) of qwen3-0.6b's per-layer deployments: the autotuner's kind
    of output, layers 0-6 cr_spline d32, 7-13 pwl d16, 14-20 poly d8 g3,
    21-27 rational g5, fused (glu_2d, each layer with its own scheme's
    params) and kernelized (elementwise_2d); a float/fixed mix (0-13
    kernelized cr_spline, 14-27 cr_fixed, which launches nothing); and the
    whole stack pinned to cr_spline d32, kernelized, which must serve the
    tokens of the uniform ``act_impl_of(cfg, "cr_spline", use_kernel=True)``."""
    from repro_torch.configs.common import act_layers_of
    from repro_torch.core.activations import ActivationConfig
    blocks = [ActivationConfig(impl="cr_spline", depth=32, use_kernel=True),
              ActivationConfig(impl="pwl", depth=16, use_kernel=True),
              ActivationConfig(impl="poly", depth=8, degree=3,
                               use_kernel=True),
              ActivationConfig(impl="rational", degree=5, use_kernel=True)]
    n = base.n_layers
    mixed = [blocks[i * len(blocks) // n] for i in range(n)]
    half = [blocks[0]] * (n // 2) + [ActivationConfig(
        impl="cr_fixed", depth=32)] * (n - n // 2)
    return [("fused", dataclasses.replace(act_layers_of(base, mixed),
                                          fuse_mlp=True)),
            ("kernelized", act_layers_of(base, mixed)),
            ("float_fixed", act_layers_of(base, half)),
            ("pinned", act_layers_of(base, ("cr_spline",) * n,
                                     use_kernel=True))]


def phase_per_layer(torch, epi, base, weights, prompts, dev, card,
                    uniform_toks):
    """Serve qwen3-0.6b at full width under each per-layer deployment, as
    phase 3 serves the uniform ones; the pinned one must give the tokens
    of the uniform kernelized cr_spline run. Returns {name: (config,
    serve line)}."""
    import gc
    from repro_torch.launch import steps as TS
    out = {}
    for dep, cfg in per_layer_configs(base):
        params = with_act(torch, weights, cfg, dev)
        engine = TS.make_engine(cfg)
        toks, _, line = phase_serve(
            torch, epi, f"serve_per_layer_{dep}", cfg, params, prompts, dev,
            card, deployment=dep,
            assignment=[c.tag() + ("+kernel" if c.use_kernel else "")
                        for c in cfg.layer_activation_configs()],
            distinct_engines=len(getattr(engine, "distinct", (engine,))))
        if dep == "pinned":
            emit({"phase": "per_layer_pinned_vs_uniform",
                  "tokens_identical": toks == uniform_toks})
            assert toks == uniform_toks, "pinned != uniform tokens"
        out[dep] = (cfg, line)
        del params
        gc.collect()
    return out


def phase_arch_traces(torch, np, registry, dev, lines):
    """One profiled decode chunk (and the sync check) of each arch run of
    phase_archs, on the same model rebuilt from the same seed."""
    from repro_torch.models import model as M
    for arch, depth in ARCH_RUNS:
        _, base = arch_config(registry, arch, depth)
        prompts = arch_prompts(np, base)
        weights = M.materialize_params(base, seed=0, device=dev)
        for dep, cfg in arch_deployments(base):
            name = f"{arch}_{dep}"
            params = with_act(torch, weights, cfg, dev)
            phase_trace(torch, name, cfg, params, prompts, dev,
                        lines[f"serve_{name}"], "paged")
            del params
            release(torch)
        del weights
        release(torch)


class RoutingLog:
    """Records, while active, every routing decision the MoE layers make
    (``models/layers.py::_route``): the top-k expert ids of each token and
    the margin between its k-th and (k+1)-th router probability."""

    def __init__(self, torch, layers):
        self.torch, self.layers = torch, layers
        self.ids, self.margins = [], []

    def __enter__(self):
        torch, orig = self.torch, self.layers._route
        self.orig = orig

        def route(router, x, k, e):
            top_w, top_i, aux = orig(router, x, k, e)
            probs = torch.softmax(x.to(torch.float32)
                                  @ router.to(torch.float32), dim=-1)
            srt = torch.sort(probs, dim=-1, descending=True).values
            self.ids.append(top_i.cpu())
            if k < e:
                self.margins.append(float((srt[..., k - 1] - srt[..., k])
                                          .min()))
            return top_w, top_i, aux

        self.layers._route = route
        return self

    def __exit__(self, *exc):
        self.layers._route = self.orig


def phase_arch_f32_vs_cpu(torch, np, epi, registry, dev, card):
    """f32 prefill logits of each arch's first served deployment (fused,
    or kernelized where there is no gated FFN to fuse), and of the MoE
    archs' kernelized ragged one (the grouped GEMM at full width), batch
    1 x ARCH_F32_TOKENS (x K planes for musicgen; qwen2-vl with patch
    embeddings and t / h / w M-RoPE positions that differ), on the card
    (kernels, each launched launches_per_forward(cfg) times) and on the
    CPU (plain versions) from the same weights: within 1e-4 relative (max
    |diff| over max |cpu|). At the served depth, or ARCH_F32_LAYERS; the
    MoE archs' top-k expert ids identical on both devices (any flip
    fails), with the smallest top-k margin printed."""
    from repro_torch.configs.common import act_impl_of
    from repro_torch.launch import steps as TS
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    tol = 1e-4
    for arch, depth in ARCH_RUNS:
        full, base = arch_config(registry, arch, ARCH_F32_LAYERS.get(
            arch, depth))
        base = dataclasses.replace(base, compute_dtype="float32")
        deps = arch_deployments(base)[:1]
        if base.n_experts:
            deps.append(("ragged", dataclasses.replace(
                act_impl_of(base, "cr_spline", use_kernel=True),
                moe_impl="ragged")))
        weights = M.materialize_params(base, seed=0, device=dev)
        weights_cpu = _tree_to(weights, "cpu")
        rng = np.random.RandomState(5)
        planes = (base.n_codebooks,) if base.n_codebooks > 1 else ()
        batch = {"tokens": rng.randint(0, base.vocab_size, (
            1, ARCH_F32_TOKENS) + planes).astype(np.int32)}
        if base.rope_kind == "mrope":
            batch["mrope_positions"] = rng.randint(
                0, ARCH_F32_TOKENS, (1, ARCH_F32_TOKENS, 3)).astype(np.int32)
        if base.patch_embed_input:
            batch["patch_embeds"] = (0.02 * rng.randn(
                1, ARCH_F32_TOKENS, base.d_model)).astype(np.float32)
        for dep, cfg in deps:
            out, routes = {}, {}
            for where, tree in ((dev, weights), ("cpu", weights_cpu)):
                p = M.compute_params(with_act(torch, tree, cfg, where), cfg)
                n0 = dict(epi.LAUNCHES)
                with RoutingLog(torch, L) as log:
                    logits, _ = M.prefill_fn(
                        p, {k: torch.as_tensor(v, device=where)
                            for k, v in batch.items()},
                        cfg, TS.make_engine(cfg), capacity=ARCH_F32_TOKENS)
                    out[str(where)] = logits.float().cpu()
                launched = {k: n - n0[k] for k, n in epi.LAUNCHES.items()}
                routes[str(where)] = log
                del p
                if where == dev:
                    assert launched == launches_per_forward(cfg), (
                        arch, dep, launched)
            a, b = out[str(dev)], out["cpu"]
            rel = float((a - b).abs().max() / b.abs().max())
            line = {"phase": "f32_vs_cpu", "deployment": f"{arch}_{dep}",
                    "card": card, "layers": cfg.n_layers,
                    "full_layers": full.n_layers,
                    "tokens": ARCH_F32_TOKENS,
                    "moe_impl": cfg.moe_impl if cfg.n_experts else None,
                    "planes": cfg.n_codebooks,
                    "batch": sorted(batch),
                    "max_abs_diff": float((a - b).abs().max()),
                    "max_abs_logit": float(b.abs().max()), "rel": rel,
                    "tolerance_rel": tol}
            same = True
            if cfg.n_experts:
                rc, rp = routes[str(dev)], routes["cpu"]
                same = len(rc.ids) == len(rp.ids) and all(
                    torch.equal(x, y) for x, y in zip(rc.ids, rp.ids))
                line.update(routing_identical=same,
                            routing_calls=len(rc.ids),
                            min_topk_margin=min(rc.margins + rp.margins))
            emit(line)
            assert same, (arch, dep, "top-k experts differ between card and "
                          "CPU", line.get("min_topk_margin"))
            assert rel <= tol, (arch, dep, rel)
        del weights, weights_cpu
        release(torch)


def train_arch_name(arch, label, deps) -> str:
    """An arch train run's name: the arch alone when it trains one
    deployment, else the arch and the deployment's label."""
    return arch if len(deps) == 1 else f"{arch}_{label}"


def train_scheme(cfg) -> str:
    """The scheme of a train run's layers (a ``*_fixed`` impl as named;
    "per_layer" under a per-layer assignment): the train line's
    ``scheme``, by which the kernels line finds each scheme's runs."""
    from repro_torch.core.activations import scheme_of
    if cfg.act_layers:
        return "per_layer"
    impl = cfg.layer_activation_configs()[0].impl
    return scheme_of(impl) or impl


def train_f32_tol(cfg, tol: float) -> float:
    """The f32 train comparison's tolerance for ``cfg``: FIXED_F32_TOL
    where a layer runs a ``*_fixed`` datapath, PWL_F32_TOL where a layer's
    unit is pwl (see both), else ``tol``."""
    from repro_torch.core.activations import fixed_scheme_of, scheme_of
    layers = cfg.layer_activation_configs()
    if any(fixed_scheme_of(c.impl) for c in layers):
        return FIXED_F32_TOL
    if any(scheme_of(c.impl) == "pwl" for c in layers):
        return PWL_F32_TOL
    return tol


def phase_train_archs(torch, epi, registry, dev, card, runs=TRAIN_ARCH_RUNS):
    """Train each arch of ``runs`` at full width (random weights, seed 0,
    bf16 compute) through phase_train, in place (TRAIN_ARCH_HYPER), each
    deployment built, trained and freed before the next. Returns {name:
    train line}."""
    from repro_torch.models import model as M
    lines = {}
    for arch, depth, deps, arch_runs in runs:
        full, base = arch_config(registry, arch, depth)
        reduced = {} if depth is None else {"n_layers": [depth,
                                                         full.n_layers]}
        for label, build in deps:
            name, cfg = train_arch_name(arch, label, deps), build(base)
            weights = M.materialize_params(base, seed=0, device=dev)
            lines[name] = phase_train(
                torch, epi, name, cfg, weights, dev, card,
                runs=arch_runs, hyper=TRAIN_ARCH_HYPER, deployment=label,
                reduced=reduced, full_layers=full.n_layers,
                params_trained=cfg.param_count())
            del weights
            release(torch)
    return lines


def phase_train_arch_traces(torch, registry, dev, lines,
                            runs=TRAIN_ARCH_RUNS):
    """One profiled train step of each arch of TRAIN_ARCH_TRACED
    (phase_train_trace), at its depth there, on the model rebuilt from the
    same seed."""
    from repro_torch.models import model as M
    for arch, _, deps, _ in runs:
        if arch not in TRAIN_ARCH_TRACED:
            continue
        _, base = arch_config(registry, arch, TRAIN_ARCH_TRACED[arch])
        for label, build in deps:
            name = train_arch_name(arch, label, deps)
            weights = M.materialize_params(base, seed=0, device=dev)
            phase_train_trace(torch, name, build(base), weights, dev,
                              lines[name], hyper=TRAIN_ARCH_HYPER)
            del weights
            release(torch)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix.lstrip("/"): tree}


class ActInputs:
    """Records, while active, a host copy of the input of every
    ``elementwise_2d`` call, kernel or plain route, in call order (the
    model reaches the wrapper through the module, as ``ShapeLog``)."""

    def __init__(self, epi):
        self.epi, self.inputs = epi, []

    def __enter__(self):
        self.orig = self.epi.elementwise_2d

        def call(x, *args, **kw):
            self.inputs.append(x.detach().cpu())
            return self.orig(x, *args, **kw)

        self.epi.elementwise_2d = call
        return self

    def __exit__(self, *exc):
        self.epi.elementwise_2d = self.orig


class NextSegmentSlope:
    """While active, the act's recompute backward (``ops._act_ref_math``)
    takes each segment's slope from the next segment's row of a pwl
    [value, delta] table (the last keeps its own): a deliberately wrong
    backward, with the forward untouched, that the f32 limit must
    refuse."""

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops

    def __enter__(self):
        torch, self.orig = self.torch, self.ops._act_ref_math
        orig = self.orig

        def wrong(spec, act, x, params):
            delta = torch.cat([params[1:, 1:], params[-1:, 1:]])
            return orig(spec, act, x, torch.cat([params[:, :1], delta], 1))

        self.ops._act_ref_math = wrong
        return self

    def __exit__(self, *exc):
        self.ops._act_ref_math = self.orig


def knot_crossings(torch, card_in, cpu_in, cfg, diff):
    """Where the card's and the CPU's gate values (``ActInputs``: one
    [tokens, F] a layer) lie in different segments of ``cfg``'s pwl unit
    under silu (the inner tanh's argument |v / 2| over the period;
    ``depth`` past x_max), set against ``diff`` ([L, d, F]: |card - CPU|
    of w_gate's gradient): the count, the worst entry with the straddling
    tokens of its column (the gate on each device and the knot between
    them, in gate units), and the 10 columns whose gradient differs most
    (their max |diff|, and how many hold a crossing)."""
    from repro_torch.core.activations import tanh_spec_of
    assert cfg.mlp_act == "silu", cfg.mlp_act
    spec = tanh_spec_of(cfg.activation)

    def seg(v):
        return torch.clamp(torch.floor((v * 0.5).abs() * spec.inv_period),
                           0, spec.depth).long()

    cross = torch.stack([seg(a) != seg(b) for a, b in zip(card_in, cpu_in)])
    cols = cross.any(dim=1)                                  # [L, F]
    colmax = diff.amax(dim=1)                                # [L, F]
    top = torch.topk(colmax.flatten(), 10).indices
    f = diff.shape[2]
    l, i, j = (int(n) for n in torch.unravel_index(diff.argmax(),
                                                   diff.shape))
    straddle = [{"token": t, "gate": {"card": float(card_in[l][t, j]),
                                      "cpu": float(cpu_in[l][t, j])},
                 "segments": [int(seg(card_in[l][t, j])),
                              int(seg(cpu_in[l][t, j]))],
                 "knot": 2.0 * spec.period * max(
                     int(seg(card_in[l][t, j])), int(seg(cpu_in[l][t, j])))}
                for t in cross[l, :, j].nonzero().flatten().tolist()]
    return {"elements": int(cross.sum()), "of": cross.numel(),
            "columns": int(cols.sum()), "of_columns": cols.numel(),
            "worst_w_gate_entry": {"layer": l, "row": i, "column": j,
                                   "abs_diff": float(diff[l, i, j])},
            "worst_column_straddles": straddle,
            "top10_columns_with_a_crossing": int(
                cols.flatten()[top].sum()),
            "top10_columns": [[int(n) // f, int(n) % f] for n in top],
            "top10_columns_max_abs_diff": colmax.flatten()[top].tolist()}


def phase_train_arch_f32_vs_cpu(torch, epi, ops, registry, dev, card,
                                runs=TRAIN_ARCH_RUNS):
    """Each arch train run's deployment at f32, batch TRAIN_F32_BATCH x
    TRAIN_F32_SEQ from the pipeline (qwen2-vl's patch embeddings and
    M-RoPE positions, musicgen's 4 planes), at the served f32 depth
    (ARCH_F32_LAYERS: MoE one layer, falcon-mamba two; else the train
    depth): the loss and its gradient (what a train step computes before
    the optimizer, which the qwen3 train_f32_vs_cpu lines hold and which
    is the same for every arch) on the card (kernels, each launched
    launches_per_forward(cfg) times) and on the CPU (plain versions), same
    weights. The loss, the gradient's global norm (the act leaf's frozen
    gradient left out, as the step clips) and every leaf's gradient (a CR
    act leaf per knot, ``knot_grad``; a Pade leaf per entry) within 1e-4
    relative (max |diff| over max |cpu|; ``train_f32_tol``: looser where
    a layer runs a ``*_fixed`` datapath or a pwl unit, but a Pade leaf
    keeps 1e-4); MoE: the top-k experts of every token identical. A pwl /
    poly act leaf's rows are printed, not gated. The kernelized pwl run
    also prints ``knot_crossings``: where w_gate's gradient differs by
    more than 1e-4, its worst entry's column must hold a gate that
    straddles a knot; and a control: the CPU's gradient under
    ``NextSegmentSlope`` must fail its limit."""
    from repro_torch.core.activations import ActivationConfig, tanh_spec_of
    from repro_torch.launch import steps as TS
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import global_norm, tree_leaves, tree_map
    tol = 1e-4

    def act_scheme(key):
        return tanh_spec_of(ActivationConfig.from_tag(
            key.split("/", 1)[1])).scheme

    def grads_on(where, tree, cfg, engine, batch):
        """loss, gnorm and every leaf's gradient (flat) on ``where``, the
        routing decisions, the act inputs and the launches."""
        leaf = tree_map(lambda t: t.detach().requires_grad_(),
                        with_act(torch, tree, cfg, where))
        batch = {k: v.to(where) for k, v in batch.items()}
        n0 = dict(epi.LAUNCHES)
        with RoutingLog(torch, L) as log, ActInputs(epi) as acts:
            loss, _ = M.loss_fn(leaf, batch, cfg, engine, remat="none")
        launched = {k: n - n0[k] for k, n in epi.LAUNCHES.items()}
        leaves = tree_leaves(leaf)
        by_id = dict(zip(map(id, leaves), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))
        grads = tree_map(lambda t: by_id[id(t)], leaf)
        got = {"loss": float(loss.detach()),
               "gnorm": float(global_norm({k: v for k, v in grads.items()
                                           if k != "act"})),
               "grads": _flat(grads)}
        return got, log, acts.inputs, launched

    def grad_rel(got, ref, on, keep_w_gate=False):
        """{"grad <leaf>": rel} of ``got``'s gradients against ``ref``'s,
        the limit of each that is not the run's, the pwl / poly rows'
        per-entry rel (printed only) and, if asked, |diff| of w_gate's
        gradient (on the host)."""
        rel, limits, rows_rel, wg = {}, {}, {}, None
        for k, g in ref["grads"].items():
            a = got["grads"][k]
            scheme = act_scheme(k) if k.startswith("act/") else None
            if scheme in ("pwl", "poly"):
                # a gate value that crosses a segment boundary moves its
                # whole contribution to the next row: no knot basis sums
                # it back, so a row's gradient is printed, not gated
                rows_rel[k] = float((a.cpu() - g).abs().max()
                                    / g.abs().max())
                continue
            if scheme == "cr_spline":
                a, g = knot_grad(torch, a.cpu()), knot_grad(torch, g)
            else:
                g = g.to(on)
                if scheme == "rational":
                    limits["grad " + k] = tol      # smooth: keeps 1e-4
            diff = (a - g).abs()
            if keep_w_gate and k == "blocks/ffn/w_gate":
                wg = diff.cpu()
            scale = float(g.abs().max())
            rel["grad " + k] = (float(diff.max()) / scale if scale
                                else float(diff.max()))
            del a, g, diff
        return rel, limits, rows_rel, wg

    for arch, depth, deps, _ in runs:
        full, base = arch_config(registry, arch,
                                 ARCH_F32_LAYERS.get(arch, depth))
        base = dataclasses.replace(base, compute_dtype="float32")
        t0 = time.perf_counter()
        weights = M.materialize_params(base, seed=0, device=dev)
        weights_cpu = _tree_to(weights, "cpu")
        cpu_batch = train_pipe(base, TRAIN_F32_BATCH, TRAIN_F32_SEQ, "cpu")(0)
        setup_s = time.perf_counter() - t0
        for label, build in deps:
            cfg = build(base)
            dep_tol = train_f32_tol(cfg, tol)
            engine = TS.make_engine(cfg)
            got, routes, acts, secs = {}, {}, {}, {}
            for where, tree in ((dev, weights), ("cpu", weights_cpu)):
                t0 = time.perf_counter()
                got[str(where)], routes[str(where)], acts[str(where)], \
                    launched = grads_on(where, tree, cfg, engine, cpu_batch)
                secs[str(where)] = time.perf_counter() - t0
                if where == dev:
                    assert launched == launches_per_forward(cfg), (
                        arch, label, launched)
            card_, cpu = got[str(dev)], got["cpu"]
            rel = {k: abs(card_[k] - cpu[k]) / abs(cpu[k])
                   for k in ("loss", "gnorm")}
            name = train_arch_name(arch, label, deps)
            scheme = train_scheme(cfg)
            # the kernelized pwl run: where the gates straddle a knot, and
            # the control
            pwl_kern = scheme == "pwl" and launches_per_forward(cfg).get(
                "elementwise_2d") == cfg.n_layers
            t0 = time.perf_counter()
            grel, limits, rows_rel, wg_diff = grad_rel(card_, cpu, dev,
                                                       keep_w_gate=pwl_kern)
            rel.update(grel)
            secs.update(setup=setup_s, compare=time.perf_counter() - t0)
            line = {"phase": "train_f32_vs_cpu_" + name, "card": card,
                    "arch": arch, "deployment": label, "scheme": scheme,
                    "moe_impl": cfg.moe_impl if cfg.n_experts else None,
                    "layers": cfg.n_layers, "full_layers": full.n_layers,
                    "batch": TRAIN_F32_BATCH, "seq": TRAIN_F32_SEQ,
                    "inputs": sorted(cpu_batch),
                    "loss": {"card": card_["loss"], "cpu": cpu["loss"]},
                    "gnorm": {"card": card_["gnorm"], "cpu": cpu["gnorm"]},
                    "launches": launches_per_forward(cfg),
                    "rel_max": max(rel.values()), "rel": rel,
                    "tolerance_rel": dep_tol, "tolerance_rel_of": limits,
                    "act_grad_compared": "CR per knot, Pade per entry",
                    "act_rows_grad_rel_not_gated": rows_rel,
                    "optimizer": "not compared here (train_f32_vs_cpu)"}
            control_failed, straddled = True, True
            if pwl_kern:
                line["knot_crossings"] = knot_crossings(
                    torch, acts[str(dev)], acts["cpu"], cfg, wg_diff)
                # the pwl limit covers knot crossings only
                straddled = (rel["grad blocks/ffn/w_gate"] <= tol or bool(
                    line["knot_crossings"]["worst_column_straddles"]))
                t0 = time.perf_counter()
                with NextSegmentSlope(torch, ops):
                    wrong = grads_on("cpu", weights_cpu, cfg, engine,
                                     cpu_batch)[0]
                crel = grad_rel(wrong, cpu, "cpu")[0]
                worst = max(crel, key=crel.get)
                control_failed = crel[worst] > dep_tol
                line["control"] = {
                    "fault": "backward takes the next segment's slope "
                             "(CPU against CPU)",
                    "loss_bitwise_equal": wrong["loss"] == cpu["loss"],
                    "rel_max": crel[worst], "leaf": worst,
                    "fails_the_limit": control_failed,
                    "seconds": time.perf_counter() - t0}
                del wrong
            line["seconds"] = {"setup": secs["setup"], "card": secs[str(dev)],
                               "cpu": secs["cpu"], "compare": secs["compare"]}
            same = True
            if cfg.n_experts:
                rc, rp = routes[str(dev)], routes["cpu"]
                same = len(rc.ids) == len(rp.ids) and all(
                    torch.equal(x, y) for x, y in zip(rc.ids, rp.ids))
                line.update(routing_identical=same,
                            routing_calls=len(rc.ids),
                            min_topk_margin=min(rc.margins + rp.margins))
            emit(line)
            del got, acts, wg_diff
            assert same, (arch, label, "top-k experts differ between card "
                          "and CPU", line.get("min_topk_margin"))
            assert all(v <= limits.get(k, dep_tol) for k, v in rel.items()), (
                name, rel)
            assert control_failed, ("a wrong pwl backward passes the limit",
                                    line["control"])
            assert straddled, ("w_gate's worst gradient column holds no "
                               "knot crossing", line["knot_crossings"])
        del weights, weights_cpu
        release(torch)


def routed_prompts(np, cfg, n):
    """``n`` distinct prompts cycling through PROMPT_LENS, from seed 3: no
    two share a cached prefix page, so no engine's run depends on what
    another request left in its pool."""
    rng = np.random.RandomState(3)
    return [rng.randint(0, cfg.vocab_size, (PROMPT_LENS[i % len(PROMPT_LENS)],)
                        ).astype(np.int32) for i in range(n)]


def routed_ecfg(**kw):
    """The EngineConfig serve_routed builds for ROUTED_PROMPTS-style
    prompts (the longest prompt, MAX_NEW tokens), for the single engine
    each routed run is held to."""
    top = max(PROMPT_LENS)
    return dict(slots=SLOTS, max_prompt_len=top, max_len=top + MAX_NEW,
                chunk=CHUNK, page_size=PAGE_SIZE, seed=0, **kw)


def single_engine(torch, cfg, params, prompts, dev, **kw):
    """One ServeEngine on ``prompts`` (routed_ecfg): (tokens per uid,
    wall seconds of the run, its EngineStats)."""
    from repro_torch.serve import EngineConfig, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(**routed_ecfg(**kw)),
                      device=dev)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    t0 = time.perf_counter()
    done = eng.run()
    return {c.uid: c.tokens for c in done}, time.perf_counter() - t0, \
        eng.stats


def routed(torch, epi, cfg, params, prompts, dev, **kw):
    """``serve_routed`` (the launcher's entry point) on ``prompts`` with
    the launch counts zeroed just before and read just after, every
    launch's shape into SERVED_SHAPES. Returns (tokens [B, MAX_NEW],
    router, launches, wall seconds)."""
    from repro_torch.launch.serve import serve_routed
    zero_launches(epi)
    t0 = time.perf_counter()
    with ShapeLog(epi) as log:
        toks, _, router = serve_routed(
            cfg, params, prompts, MAX_NEW, slots=SLOTS, chunk=CHUNK,
            page_size=PAGE_SIZE, device=dev, **kw)
    wall = time.perf_counter() - t0
    for key, n in log.shapes.items():
        SERVED_SHAPES[key] = SERVED_SHAPES.get(key, 0) + n
    return toks, router, dict(epi.LAUNCHES), wall


def fleet_forwards(router) -> int:
    st = router.engine_totals()
    return st.prefill_batches + st.prefill_chunks + st.decode_steps


def phase_routed(torch, np, epi, cfg, weights, dev, card):
    """The multi-replica tier on the card (qwen3-0.6b at full width, bf16,
    fused cr_spline: glu_2d on every FFN), through ``serve_routed``. Every
    engine admits serially (admission="serial"): a request's prefill is a
    batch of one wherever it lands, so its GEMMs have the same shapes as
    on one engine (batched admission groups requests by placement, and a
    bf16 GEMM of another shape may round otherwise).

    ``serve_routed``: 2 in-process replicas serve 8 greedy requests
    (PROMPT_LENS twice, MAX_NEW tokens): tokens per request equal one
    engine's on the same 8; glu_2d launches launches_per_forward x the
    fleet's forwards (summed over replicas), all tma_wgmma; the replicas'
    weight tensors the same storage; completed == submitted. Prints the
    fleet's and the single engine's decode tok/s (information), the
    router- and engine-queue waits p50 / p99 and peak memory.

    ``serve_routed_backpressure``: queue_limit=2 under "reject" and
    "shed", 12 requests: completed + shed + rejected == submitted, every
    surviving request the single engine's tokens, the dropped rows zero,
    every replica's pages back (pages_in_use 0).

    ``serve_routed_autoscale``: AutoscaleConfig(1..3 replicas, window 2),
    a burst of 12 requests from one replica, then idle router steps:
    at least one scale-up and one scale-down (a drained replica retired),
    every request completed."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve import AutoscaleConfig
    params = with_act(torch, weights, cfg, dev)
    kw = {"admission": "serial"}
    p8, p12 = routed_prompts(np, cfg, 8), routed_prompts(np, cfg, 12)
    single_engine(torch, cfg, params, p8[:len(PROMPT_LENS)], dev, **kw)
    torch.cuda.synchronize()
    want8, single_wall, single_st = single_engine(torch, cfg, params, p8,
                                                  dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    toks, router, launches, wall = routed(torch, epi, cfg, params, p8, dev,
                                          replicas=2, **kw)
    peak = torch.cuda.max_memory_allocated()
    rs, st = router.stats, router.engine_totals()
    want = {k: n * fleet_forwards(router)
            for k, n in launches_per_forward(cfg).items()}
    engines = [r.engine for _, r in sorted(router.replicas.items())]
    ptrs = [[t.data_ptr() for t in tree_leaves(e.params)] for e in engines]
    done = sorted(router.completions, key=lambda c: c.uid)
    line = routed_line = {
            "phase": "serve_routed", "card": card, "arch": cfg.name,
            "layers": cfg.n_layers, "replicas": len(engines),
            "requests": len(p8), "engine_kw": kw,
            "submitted": rs.submitted, "completed": rs.completed,
            "tokens_identical_to_single_engine": all(
                toks[u].tolist() == want8[u] for u in range(len(p8))),
            "launches": launches, "want_launches": want,
            "fleet_forwards": fleet_forwards(router),
            "weights_shared": all(p == ptrs[0] for p in ptrs[1:]),
            "weight_tensors": len(ptrs[0]),
            "fleet_decode_tokens_per_s": st.decode_tokens_per_s,
            "single_decode_tokens_per_s": single_st.decode_tokens_per_s,
            "fleet_wall_s": wall, "single_wall_s": single_wall,
            "router_queue_ms_p50_p99": np.percentile(
                [c.router_queue_s * 1e3 for c in done], (50, 99)).tolist(),
            "engine_queue_ms_p50_p99": np.percentile(
                [c.engine_queue_s * 1e3 for c in done], (50, 99)).tolist(),
            "max_memory_allocated_gb": peak / 1e9,
            "per_replica_forwards": [
                r.stats().prefill_batches + r.stats().decode_steps
                for _, r in sorted(router.replicas.items())]}
    emit(line)
    assert line["tokens_identical_to_single_engine"], "routed != single"
    assert launches == want, (launches, want)
    assert epi.GLU_VARIANTS["tma_wgmma"] == launches["glu_2d"], \
        dict(epi.GLU_VARIANTS)
    assert line["weights_shared"] and len(engines) == 2
    assert rs.completed == rs.submitted == len(p8), rs
    router.close()
    del router, engines, toks

    want12, _, _ = single_engine(torch, cfg, params, p12, dev, **kw)
    out = {"phase": "serve_routed_backpressure", "card": card,
           "requests": len(p12), "queue_limit": 2, "replicas": 2}
    for policy in ("reject", "shed"):
        toks, router, launches, _ = routed(
            torch, epi, cfg, params, p12, dev, replicas=2, queue_limit=2,
            policy=policy, **kw)
        rs = router.stats
        zero = [b for b in range(len(p12)) if not toks[b].any()]
        out[policy] = {
            "submitted": rs.submitted, "completed": rs.completed,
            "shed": rs.shed, "rejected": rs.rejected,
            "shed_rate": rs.shed_rate, "reject_rate": rs.reject_rate,
            "queue_peak": rs.queue_peak, "zero_rows": zero,
            "survivors_identical": all(toks[b].tolist() == want12[b]
                                       for b in range(len(p12))
                                       if b not in zero),
            "pages_in_use": [r.stats().pages_in_use
                             for r in router.replicas.values()],
            "launches": launches,
            "want_launches": {k: n * fleet_forwards(router) for k, n in
                              launches_per_forward(cfg).items()}}
        router.close()
        del router
    emit(out)
    for policy in ("reject", "shed"):
        o = out[policy]
        assert o["completed"] + o["shed"] + o["rejected"] == o["submitted"] \
            == len(p12), o
        assert o["shed" if policy == "shed" else "rejected"] > 0, o
        assert len(o["zero_rows"]) == o["shed"] + o["rejected"], o
        assert o["survivors_identical"], (policy, "survivor != single")
        assert o["pages_in_use"] == [0, 0], o
        assert o["launches"] == o["want_launches"], o

    acfg = AutoscaleConfig(min_replicas=1, max_replicas=3, window=2)
    toks, router, launches, wall = routed(
        torch, epi, cfg, params, p12, dev, replicas=1, autoscale=acfg, **kw)
    burst = dataclasses.asdict(router.stats)
    idle = 0
    while (len(router.replicas) > acfg.min_replicas
           and idle < 40 * acfg.window):
        router.step()
        idle += 1
    rs = router.stats
    line = {"phase": "serve_routed_autoscale", "card": card,
            "autoscale": dataclasses.asdict(acfg), "requests": len(p12),
            "burst": burst, "idle_steps": idle,
            "after_idle": dataclasses.asdict(rs),
            "replicas_left": sorted(router.replicas), "wall_s": wall,
            "tokens_identical_to_single_engine": all(
                toks[b].tolist() == want12[b] for b in range(len(p12)))}
    emit(line)
    assert burst["completed"] == burst["submitted"] == len(p12), burst
    assert rs.scale_ups >= 1 and rs.scale_downs >= 1 and rs.retired >= 1, rs
    assert len(router.replicas) == acfg.min_replicas
    assert line["tokens_identical_to_single_engine"], "autoscaled != single"
    router.close()
    del router, params
    release(torch)
    return routed_line


def phase_process_replica(torch, np, base, dev, card, smoke=False):
    """``ProcessReplica`` on the card: a spawned worker opens its own CUDA
    context, materializes qwen3-0.6b at full width from seed 0 and casts
    it to bf16 (ReplicaSpec defaults), and serves 4 greedy requests
    (PROMPT_LENS, MAX_NEW tokens) with the tokens of an InProcessReplica
    built here from ``materialize_params(cfg, seed=0)`` cast the same
    way; the worker exits 0 after close(). The spec's config is the
    registry's (its plain activation engine: no kernel of the port runs
    there), and a worker's launches would not reach this process's
    counters anyway."""
    from repro_torch.launch.serve import _tree_cast
    from repro_torch.models import model as M
    from repro_torch.serve import (EngineConfig, InProcessReplica,
                                   ProcessReplica, ReplicaSpec, Router,
                                   RouterConfig, ServeEngine)
    ecfg = routed_ecfg()
    prompts = routed_prompts(np, base, len(PROMPT_LENS))
    t0 = time.perf_counter()
    remote = ProcessReplica(ReplicaSpec(arch="qwen3-0.6b", smoke=smoke,
                                        seed=0, engine=ecfg, device=str(dev)))
    startup = time.perf_counter() - t0
    try:
        params = _tree_cast(M.materialize_params(base, seed=0, device=dev),
                            torch.bfloat16)
        local = InProcessReplica(ServeEngine(base, params,
                                             EngineConfig(**ecfg), device=dev))
        free, total = torch.cuda.mem_get_info()
        out = {}
        for name, rep in (("in_process", local), ("process", remote)):
            router = Router(lambda rid, rep=rep: rep, RouterConfig())
            for p in prompts:
                router.submit(p, max_new=MAX_NEW)
            t0 = time.perf_counter()
            out[name] = ({c.uid: c.tokens for c in router.run()},
                         time.perf_counter() - t0)
        worker_stats = dataclasses.asdict(remote.stats())
    finally:
        remote.close()
    line = {"phase": "serve_process_replica", "card": card,
            "arch": base.name, "layers": base.n_layers,
            "activation": base.activation.tag(), "requests": len(prompts),
            "startup_s": startup,
            "serve_s": {k: v[1] for k, v in out.items()},
            "card_memory_used_gb_both_contexts": (total - free) / 1e9,
            "tokens_identical": out["process"][0] == out["in_process"][0],
            "worker_exitcode": remote.exitcode,
            "worker_prefill_requests": worker_stats["prefill_requests"],
            "worker_decode_tokens": worker_stats["decode_tokens"],
            "launches": "not counted: the worker's kernel counters live in "
                        "its own process, and the registry config runs no "
                        "kernel of the port"}
    emit(line)
    assert line["tokens_identical"], "process replica != in-process"
    assert remote.exitcode == 0, remote.exitcode
    assert all(len(t) == MAX_NEW for t in out["process"][0].values())
    del local, params
    release(torch)


# ROADMAP item 12: tensor-parallel serving on the one card. NCCL refuses
# two ranks on one device, so TP_WORLD ranks share cuda:0 and talk
# through gloo (asked for by name), which stages every CUDA tensor through
# the host: the rates the serve_tp lines print are two or four processes
# sharing one card, information and never a speed claim. Each run: (arch,
# depth, deployment of arch_deployments, TP width, engine kwargs, compute
# dtype or None for the config's bf16). qwen3-0.6b in bf16 (glu_2d's
# tma_wgmma and elementwise_2d at the shard widths) at TP 2 and 4 on the
# paged pool, at TP 2 on the slot cache, chunked and kernelized; at f32 at
# TP 2 and 4, all at 4 of 28 layers (the bf16 runs served all 28 and the
# f32 runs 8 until the script passed its 1,200 s limit on a slow host:
# 1,245 s, the TP and sharded block 311 s of it; 194 s at 8 layers); then
# the layouts at f32 and 4 layers:
# qwen2.5-3b at TP 4 (KV = 2 stays whole while 16 heads shard),
# hymba-1.5b at TP 2 (25 heads stay whole, d_inner shards),
# musicgen-large at TP 2 (K = 4 codebook planes, vocab-parallel
# embeddings and heads) and mixtral-8x22b at TP 2 (ragged, the router's
# expert dim sharded).
TP_WORLD = 4
TP_BACKEND = "gloo"
TP_RUNS = (
    ("qwen3-0.6b", 4, "fused", 2, {}, None),
    ("qwen3-0.6b", 4, "fused", 4, {}, None),
    ("qwen3-0.6b", 4, "fused", 2, {"chunk_prefill": CHUNK_PREFILL}, None),
    ("qwen3-0.6b", 4, "fused", 2, {"cache": "slot"}, None),
    ("hymba-1.5b", 4, "fused", 2, {}, "float32"),
    ("qwen3-0.6b", 4, "kernelized", 2, {}, None),
    ("mixtral-8x22b", 1, "ragged", 2, {}, "float32"),
    ("qwen3-0.6b", 4, "fused", 2, {}, "float32"),
    ("qwen3-0.6b", 4, "fused", 4, {}, "float32"),
    ("qwen2.5-3b", 4, "fused", 4, {}, "float32"),
    ("musicgen-large", 4, "kernelized", 2, {}, "float32"),
)
# prefill logits on tp_logit_tokens, TP against TP=1, relative to TP=1's
# largest |logit|. At f32 the row-parallel products sum f32 partials in
# another order than one GEMM: TP 2 read 1.42e-6 on qwen3-0.6b's 28
# layers (NVIDIA H100 80GB HBM3, 700.00 W); the f32 runs must also give
# TP=1's greedy tokens. At bf16 that order decides a few roundings to
# bf16 a layer, and random weights carry the one-ulp steps through every
# later layer: TP 2 / 4 read 0.81e-2 - 1.77e-2 over the runs (the port's
# bf16 logits differ from the reference's by as much, ROADMAP "Not
# faults"), so bf16 tokens agree with TP=1's only up to near-ties, and
# the bf16 runs are held to TP_BF16_TOL and to equal tokens on every
# rank and between TP caches (the same arithmetic).
TP_F32_TOL = 1e-5
TP_BF16_TOL = 5e-2
TP_LOGIT_TOKENS = 32
# sharded training (ROADMAP item 12b): the serve_tp ranks train after
# serving, on (data, model) meshes over all TP_WORLD ranks (at 4 layers,
# as TP_RUNS, for the same reason). Entries:
# (arch, layers or None for all, deployment, (data, model), dtype or None
# for the arch's bf16). The bf16 runs take TRAIN_SHARDED_STEPS steps at a
# global TRAIN_BATCH x TRAIN_SEQ; the f32 runs one step (step 1: at step
# 0 the warmup lr is 0) at TRAIN_SHARDED_F32_BATCH x TRAIN_F32_SEQ (every
# data rank a row), each against the one-process step on the card from
# the same weights and batch. mixtral stays on the CPU test (tests/test_torch_train_sharded.py):
# a rank gathers its f32 experts whole, over a quarter of the card.
TRAIN_SHARDED_RUNS = (
    ("qwen3-0.6b", 4, "fused", (2, 2), None),
    ("qwen3-0.6b", 4, "kernelized", (2, 2), None),
    ("qwen3-0.6b", 4, "fused", (2, 2), "float32"),
    ("qwen3-0.6b", 4, "fused", (4, 1), "float32"),
    ("qwen3-0.6b", 4, "fused", (1, 4), "float32"),
    ("hymba-1.5b", 4, "fused", (2, 2), "float32"),
)
TRAIN_SHARDED_STEPS = 3
TRAIN_SHARDED_F32_BATCH = 4
# f32 sharded against one process, both on the card: the loss and gnorm
# relative (the row-parallel and data sums add f32 partials in another
# order); each gradient leaf relative to its largest |g| (as
# train_f32_vs_cpu's 1e-4); each leaf's update, the L2 norm of the
# difference of the params after the step over the norm of the
# one-process update. Not the params element by element: Adam's first
# update is lr * g / (|g| + eps), so an element whose gradient is near
# eps (~1e-5 of its leaf's largest, where the f32 sums' rounding is of
# the order of eps) moves by up to lr either way: 0.04-0.21 x the peak
# lr read in a step of qwen3 and hymba (printed as param_abs_over_lr),
# where the gradients agreed within 8e-6; the updates read <= 1.2e-3
# (NVIDIA H100 80GB HBM3, 700 W). A lost, doubled or misplaced update
# reads ~1 or more.
TRAIN_SHARDED_SCALAR_TOL = 1e-5
TRAIN_SHARDED_GRAD_TOL = 1e-4
TRAIN_SHARDED_UPDATE_TOL = 1e-2


def tp_config(registry, run):
    """(config, full layers) of a TP_RUNS entry: the arch at its served
    depth (widths never cut), the deployment, the compute dtype."""
    arch, depth, dep, _, _, dtype = run
    full, base = arch_config(registry, arch, depth)
    cfg = dict(arch_deployments(base))[dep]
    if dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return cfg, full.n_layers


def tp_name(run) -> str:
    arch, _, dep, tp, kw, dtype = run
    extra = "".join(f"_{v}" if k == "cache" else f"_{k}{v}"
                    for k, v in kw.items())
    return f"serve_tp_{arch}_{dep}{extra}{'_f32' if dtype else ''}_tp{tp}"


def tp_logit_tokens(np, cfg):
    """[1, TP_LOGIT_TOKENS] prompt tokens ([1, T, K] for K codebook
    planes) from seed 11, for the TP runs' prefill logits."""
    rng = np.random.RandomState(11)
    planes = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return rng.randint(0, cfg.vocab_size,
                       (1, TP_LOGIT_TOKENS) + planes).astype(np.int32)


def tp_schedule(runs, world):
    """Which ranks serve each run: the TP 2 runs alternate between ranks
    (0, 1) and (2, 3), the two pairs serving at once; then every wider
    run on ranks 0 .. tp-1 in turn. Returns (TP 2 runs as (index,
    ranks), wider runs as (index, ranks))."""
    two = [i for i, run in enumerate(runs) if run[3] == 2]
    pairs = [tuple(range(p, p + 2)) for p in range(0, world, 2)]
    return ([(i, pairs[k % len(pairs)]) for k, i in enumerate(two)],
            [(i, tuple(range(run[3]))) for i, run in enumerate(runs)
             if run[3] != 2])


def _tp_rank(rank, world, dev, runs):
    """One rank of the serve_tp group (``tp_schedule``): this rank's TP 2
    runs, a world barrier, then each wider run. For a run, each of its
    ranks materializes the full weights from seed 0 on the card in turn,
    keeps its shards (``shard_params``) and frees the rest, then drives
    the run (``drive``: exact launches, every request complete, every
    page back) with its launch counts zeroed, then counts the host syncs
    of one more decode chunk. Returns {run index: result} of the runs
    this rank served."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.kernels import epilogue as epi
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M
    from repro_torch.parallel import partition as part
    from repro_torch.parallel import tp as TPC
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs, wide = tp_schedule(runs, world)
    meshes = {ranks: LM.make_host_mesh(1, len(ranks), device="cuda",
                                       ranks=ranks)
              for ranks in sorted({r for _, r in pairs + wide})}
    out = {}
    for stage in (pairs, wide):
        for i, ranks in stage:
            if rank in ranks:
                out[i] = _tp_serve(torch, np, dist, epi, registry, TS, M,
                                   part, TPC, dev, meshes[ranks], runs[i])
            if stage is wide:
                dist.barrier()
        dist.barrier()
    out["train"] = _train_sharded_rank(rank, world, dev)
    return out


def _tp_serve(torch, np, dist, epi, registry, TS, M, part, TPC, dev, mesh,
              run):
    """One TP run on this rank (``_tp_rank``)."""
    n = part.mesh_shape(mesh)["model"]
    group = mesh.get_group("model")
    me = mesh.get_local_rank("model")
    cfg, _ = tp_config(registry, run)
    psh = TS.serve_shardings(cfg, SLOTS, MAX_LEN, mesh)[0]
    local = None
    for r in range(n):
        if r == me:
            w = M.materialize_params(cfg, seed=0, device=dev)
            local = M.compute_params(M.shard_params(w, cfg, psh), cfg)
            del w
            release(torch)
        dist.barrier(group=group)
    g = TPC.group_of(mesh)
    g.reset()
    torch.cuda.reset_peak_memory_stats()
    got = drive(torch, epi, cfg, local, arch_prompts(np, cfg), dev,
                mesh=mesh, **run[4])
    calls, nbytes = g.calls, g.bytes
    eng, st = got.eng, got.eng.stats
    res = {"tokens": got.toks, "launches": got.launches,
           "variants": got.variants, "shapes": got.shapes,
           "collectives": calls, "collective_bytes": nbytes,
           "forwards": st.prefill_batches + st.prefill_chunks
           + st.decode_steps, "prefill_batches": st.prefill_batches,
           "prefill_chunks": st.prefill_chunks,
           "decode_steps": st.decode_steps,
           "paged": eng.paged, "chunked": eng.chunked,
           "decode_tokens_per_s": st.decode_tokens_per_s,
           "prefill_tokens_per_s": st.prefill_tokens_per_s,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "local_weights_gb": tree_gb(eng.params),
           "local_cache_gb": tree_gb(eng.cache)}
    if run[0] == "qwen3-0.6b" and not run[4]:
        # one more decode chunk of this engine: its host syncs and
        # collectives (qwen3's paged runs: the layouts cost the same)
        for pr in arch_prompts(np, cfg)[:SLOTS]:
            eng.submit(pr, max_new=MAX_NEW)
        eng.step()                  # admission + first decode chunk
        chunk = eng._decode_at(CHUNK)
        g.reset()
        res["decode_chunk_host_syncs"] = host_syncs(torch, lambda: chunk(
            eng.params, eng.cache, eng.state, 0, [0] * SLOTS,
            [0] * SLOTS, [0.0] * SLOTS))
        torch.cuda.synchronize()
        res["collectives_per_decode_step"] = g.calls / CHUNK
    toks = torch.as_tensor(tp_logit_tokens(np, cfg), device=dev)
    with part.axis_rules(mesh, part.serve_rules()):
        logits, _ = M.prefill_fn(local, {"tokens": toks}, cfg,
                                 TS.make_engine(cfg))
    res["logits"] = logits.float().cpu().numpy()
    del eng, local, got
    release(torch)
    return res


def _train_sharded_rank(rank, world, dev, runs=TRAIN_SHARDED_RUNS):
    """This rank's part of every sharded train run (``runs``), on (data,
    model) meshes over the whole world: {run index: result}. A spawn_ranks
    function of its own too (dev runs of the phase alone)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as LM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {shape: LM.make_host_mesh(*shape,
                                       device=torch.device(dev).type)
              for shape in sorted({run[3] for run in runs})}
    out = {}
    for i, run in enumerate(runs):
        out[i] = _train_sharded(torch, dist, rank, dev, meshes[run[3]], run)
        dist.barrier()
    return out


def train_sharded_config(registry, run):
    """(config, full layers) of a TRAIN_SHARDED_RUNS entry."""
    arch, depth, dep, _, dtype = run
    return tp_config(registry, (arch, depth, dep, None, None, dtype))


def _leaf_rel(torch, got, want, scale=None) -> dict:
    """{leaf: max|got - want| over max|want| (or over ``scale``)}; an act
    leaf per knot (``knot_grad``), its per-entry value under
    ``<leaf>:entries``."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), set(g) ^ set(w)
    rel = lambda a, b: float((a.double() - b.double()).abs().max()
                             / (scale or max(float(b.abs().max()), 1e-30)))
    out = {}
    for k in w:
        if k.startswith("act/"):
            out[k + ":entries"] = rel(g[k], w[k])
            out[k] = rel(knot_grad(torch, g[k].cpu()),
                         knot_grad(torch, w[k].cpu()))
        else:
            out[k] = rel(g[k], w[k])
    return out


def _worst(by_leaf: dict) -> tuple:
    """(worst value, its leaf) of ``_leaf_rel``-like numbers, per-entry
    act values left out."""
    return max((v, k) for k, v in by_leaf.items() if ":" not in k)


def _grads_at_start(torch, TS, M, cfg, hyper, params, batch, fsdp=None):
    """``loss_fn`` differentiated once. Sharded (``fsdp``): this rank's
    rows, the gradients' data mean, every leaf gathered whole on the card
    (every rank joins; the mesh's first rank keeps them, the others get
    None)."""
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel import dp as DP
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    if fsdp is not None and fsdp.group is not None:
        batch = DP.local_rows(batch, fsdp.group.rank, fsdp.group.size)
    loss, _ = M.loss_fn(p, batch, cfg, TS.make_engine(cfg),
                        remat=hyper.remat, z_loss=hyper.z_loss, fsdp=fsdp)
    leaves = tree_leaves(p)
    got = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    grads = tree_map(lambda t: got[id(t)], p)
    if fsdp is None:
        return grads
    lead = all(fsdp.mesh.get_local_rank(a) == 0
               for a in fsdp.mesh.mesh_dim_names)
    whole = fsdp.whole(fsdp.reduce_grads(grads), lead)
    return tree_map(lambda g: g.to(loss.device), whole) if lead else None


def _train_one_process(torch, TS, M, cfg, hyper, batch, dev):
    """The one-process f32 baseline of a sharded run, on the card: the
    gradients at the start, then step 1 on ``batch`` (its loss and gnorm,
    the params before and after)."""
    from repro_torch.optim import adamw
    params = M.materialize_params(cfg, seed=0, device=dev)
    out = {"grads": _grads_at_start(torch, TS, M, cfg, hyper, params,
                                    batch), "params0": params}
    out["params"], _, m = TS.make_train_step(cfg, hyper)(
        params, adamw.init_state(params), batch, 1)
    out["losses"], out["gnorms"] = [float(m["loss"])], [float(m["gnorm"])]
    return out


def _train_sharded(torch, dist, rank, dev, mesh, run):
    """One TRAIN_SHARDED_RUNS entry on this rank: for an f32 run rank 0
    first runs the one-process baseline; then each rank draws the
    weights from seed 0 on the card in turn, keeps its blocks
    (``ShardedState.shardings``) and frees the rest; f32: the gathered
    gradients at the start; then a sharded ``TrainDriver`` runs the steps
    with the launch and collective counts zeroed (bf16: the last under
    CUDA's sync debug mode); f32: the gathered params after the step.
    Returns this rank's numbers (rank 0's with the comparisons)."""
    import tempfile
    t_run = time.perf_counter()
    from repro_torch.configs import registry
    from repro_torch.ft import FTConfig, TrainDriver
    from repro_torch.kernels import epilogue as epi
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel import dp as DP
    from repro_torch.parallel import partition as part
    from repro_torch.parallel import tp as TPC
    cfg, _ = train_sharded_config(registry, run)
    f32 = run[4] == "float32"
    hyper = TS.TrainHyper(remat="none", opt=train_opt())
    rows, seq, steps, first = ((TRAIN_SHARDED_F32_BATCH, TRAIN_F32_SEQ, 1, 1)
                               if f32 else
                               (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SHARDED_STEPS,
                                0))
    pipe = train_pipe(cfg, rows, seq, dev)
    lead = rank == 0
    base = None
    if f32 and lead:
        base = _train_one_process(torch, TS, M, cfg, hyper, pipe(first), dev)
        release(torch)
    dist.barrier()
    state = TS.ShardedState(cfg, mesh, hyper=hyper)
    local = None
    for r in range(dist.get_world_size()):
        if r == rank:
            w = M.materialize_params(cfg, seed=0, device=dev)
            local = M.shard_params(w, cfg, state.shardings)
            del w
            release(torch)
        dist.barrier()
    res = {"local_params_gb": tree_gb(local)}
    if f32:
        with part.axis_rules(mesh):
            grads = _grads_at_start(torch, TS, M, cfg, hyper, local,
                                    pipe(first), state.fsdp)
        if lead:
            res["grad_rel"] = _leaf_rel(torch, grads, base["grads"])
        del grads
    shape = part.mesh_shape(mesh)
    groups = {axis: g for axis, g in (
        ("model", TPC.group_of(mesh) if shape["model"] > 1 else None),
        ("data", DP.group_of(mesh) if shape["data"] > 1 else None)) if g}
    step_fn = TS.make_train_step(cfg, hyper, mesh=mesh)
    opt = adamw.init_state(local)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for g in groups.values():
        g.reset()
    zero_launches(epi)
    with tempfile.TemporaryDirectory() as ckpt, ShapeLog(epi) as log:
        drv = TrainDriver(step_fn, pipe, local, opt, FTConfig(
            ckpt_dir=ckpt, ckpt_every=10 ** 9, log_every=0),
            start_step=first, log=lambda *_: None, sharded=state)
        del local, opt
        if f32:
            drv.run(steps)
        else:
            # the last step under CUDA's sync debug mode: its host syncs
            drv.run(steps - 1)
            torch.cuda.synchronize()
            res["host_syncs_per_step"] = host_syncs(torch,
                                                    lambda: drv.run(1))
    torch.cuda.synchronize()
    recs = drv.history
    res.update(
        launches=dict(epi.LAUNCHES), variants=dict(epi.GLU_VARIANTS),
        shapes=log.shapes, losses=[r.loss for r in recs],
        gnorms=[r.gnorm for r in recs],
        skipped=sum(r.skipped for r in recs),
        step_wall_ms=[r.wall_s * 1e3 for r in recs],
        collectives_per_step={a: g.calls / steps for a, g in groups.items()},
        collective_mb_per_step={a: g.bytes / 1e6 / steps
                                for a, g in groups.items()},
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if f32:
        whole = state.fsdp.whole(drv.params, lead)
        if lead:
            whole = tree_map(lambda t: t.to(dev), whole)
            # in units of the peak lr, per element (information)
            res["params_rel"] = _leaf_rel(torch, whole, base["params"],
                                          hyper.opt.lr_peak)
            got, want = _flat(whole), _flat(base["params"])
            res["update_rel"] = {
                k: float((got[k].double() - want[k].double()).norm()
                         / (want[k].double() - p0.double()).norm())
                for k, p0 in _flat(base["params0"]).items()}
        del whole
        if lead:
            res["base_losses"] = base["losses"]
            res["base_gnorms"] = base["gnorms"]
    del drv, state
    release(torch)
    res["run_s"] = time.perf_counter() - t_run
    return res


def train_sharded_name(run) -> str:
    arch, _, dep, (d, m), dtype = run
    return (f"train_sharded_{arch}_{dep}{'_f32' if dtype else ''}"
            f"_dp{d}_tp{m}")


def phase_train_sharded(torch, registry, card, ranks):
    """The ``train_sharded_*`` lines from the ranks' results
    (``_train_sharded``) and their gates: every loss finite and no step
    skipped; loss and gnorm the same bits on every rank; each rank's
    launches exactly ``launches_per_forward`` x steps (one forward a step:
    no remat), every glu_2d launch on the TMA variant of its type and
    rows (``glu_variant_tally``: bf16 ``tma_wgmma_gemm`` at a rank's 512
    rows, f32 ``tma_f32``), the counts by variant exact; f32: loss and
    gnorm within
    TRAIN_SHARDED_SCALAR_TOL of the one-process step's, every gradient
    leaf within TRAIN_SHARDED_GRAD_TOL, every leaf's update within
    TRAIN_SHARDED_UPDATE_TOL (see there). Host syncs are printed,
    not gated (gloo waits once a collective). Each line carries
    ``kernel_shapes`` and ``launches`` (rank 0's) as serve lines do, so
    phase 4 times its launch shapes; they join SERVED_SHAPES. Returns
    {line name: line}."""
    from repro_torch.kernels import epilogue as epi
    lines, fails = {}, []
    lr_peak = train_opt().lr_peak
    for i, run in enumerate(TRAIN_SHARDED_RUNS):
        arch, depth, dep, (d, m), dtype = run
        cfg, full_layers = train_sharded_config(registry, run)
        got = [r["train"][i] for r in ranks]
        r0 = got[0]
        f32 = dtype == "float32"
        steps = 1 if f32 else TRAIN_SHARDED_STEPS
        rows, seq = ((TRAIN_SHARDED_F32_BATCH, TRAIN_F32_SEQ) if f32
                     else (TRAIN_BATCH, TRAIN_SEQ))
        per_fwd = launches_per_forward(cfg)
        want = {k: n * steps for k, n in per_fwd.items()}
        tallies = [glu_variant_tally(epi, r["shapes"]) for r in got]
        walls = r0["step_wall_ms"]
        # the first step warms up; a bf16 run's last ran in sync debug mode
        steady = walls[0] if f32 else statistics.median(walls[1:-1])
        name = train_sharded_name(run)
        line = {"phase": name, "card": card, "arch": cfg.name,
                "layers": cfg.n_layers, "full_layers": full_layers,
                "deployment": dep, "compute_dtype": cfg.compute_dtype,
                "mesh": {"data": d, "model": m}, "backend": TP_BACKEND,
                "batch": rows, "seq": seq, "steps": steps,
                "first_step": 1 if f32 else 0, "remat": "none",
                "launches_per_forward": per_fwd, "launches": r0["launches"],
                "launches_per_rank": [r["launches"] for r in got],
                "glu_variants": r0["variants"],
                "kernel_shapes": [[k, list(shape), dt, act, n]
                                  for (k, shape, dt, act, _), n in
                                  sorted(r0["shapes"].items(), key=repr)],
                "losses": r0["losses"], "gnorms": r0["gnorms"],
                "skipped": r0["skipped"], "step_wall_ms": walls,
                "step_wall_ms_median": steady,
                "train_tokens_per_s": rows * seq / steady * 1e3,
                "collectives_per_step": r0["collectives_per_step"],
                "collective_mb_per_step": r0["collective_mb_per_step"],
                "max_memory_allocated_gb_per_rank":
                    [r["max_memory_allocated_gb"] for r in got],
                "local_params_gb": r0["local_params_gb"],
                "host_syncs_per_step": [r.get("host_syncs_per_step")
                                        for r in got],
                "run_s": [r["run_s"] for r in got],
                "same_loss_gnorm_bits_on_every_rank": all(
                    (r["losses"], r["gnorms"]) == (r0["losses"],
                                                   r0["gnorms"])
                    for r in got),
                "rates_note": f"{d * m} ranks through {TP_BACKEND} "
                              "(host-staged collectives) on one card "
                              "they share: information, not a speed "
                              "claim"}
        if depth is not None:
            line["reduced"] = {"n_layers": [depth, full_layers]}
        if f32:
            rel = lambda a, b: abs(a - b) / abs(b)
            line.update(
                one_process_losses=r0["base_losses"],
                one_process_gnorms=r0["base_gnorms"],
                loss_rel=max(map(rel, r0["losses"], r0["base_losses"])),
                gnorm_rel=max(map(rel, r0["gnorms"], r0["base_gnorms"])),
                grad_rel=_worst(r0["grad_rel"]),
                update_rel=_worst(r0["update_rel"]),
                param_abs_over_lr=_worst(r0["params_rel"]),
                by_leaf={k: r0[k] for k in ("grad_rel", "update_rel",
                                            "params_rel")},
                tolerances={"scalar_rel": TRAIN_SHARDED_SCALAR_TOL,
                            "grad_rel": TRAIN_SHARDED_GRAD_TOL,
                            "update_rel": TRAIN_SHARDED_UPDATE_TOL})
        emit(line)
        lines[name] = line
        checks = [
            ("a loss not finite or a step skipped",
             all(math.isfinite(x) for x in r0["losses"])
             and r0["skipped"] == 0),
            ("loss / gnorm bits differ across ranks",
             line["same_loss_gnorm_bits_on_every_rank"]),
            ("launches not launches_per_forward x steps on every rank",
             all(r["launches"] == want for r in got)),
            ("glu_2d off the TMA variant of its type and rows", all(
                not off and r["variants"] == want
                and sum(want.values()) == r["launches"]["glu_2d"]
                for r, (want, off) in zip(got, tallies))),
            ("bf16 glu_2d off tma_wgmma_gemm", f32 or all(
                r["variants"]["tma_wgmma_gemm"] == r["launches"]["glu_2d"]
                for r in got))]
        if f32:
            checks += [
                ("loss / gnorm off the one-process step's", max(
                    line["loss_rel"], line["gnorm_rel"])
                 <= TRAIN_SHARDED_SCALAR_TOL),
                ("a gradient leaf off the one-process step's",
                 line["grad_rel"][0] <= TRAIN_SHARDED_GRAD_TOL),
                ("an update off the one-process step's",
                 line["update_rel"][0] <= TRAIN_SHARDED_UPDATE_TOL)]
        fails += [f"{name}: {what}" for what, ok in checks if not ok]
        for key, n in r0["shapes"].items():
            SERVED_SHAPES[key] = SERVED_SHAPES.get(key, 0) + n
    assert not fails, fails
    return lines


def tree_gb(tree) -> float:
    return sum(t.numel() * t.element_size()
               for t in _flat(tree).values()) / 1e9


def tp_baselines(torch, np, epi, registry, dev, served):
    """TP=1 of every TP_RUNS entry, keyed by tp_name with tp 1: phase 3's
    tokens and launches where it served the same thing (qwen3-0.6b bf16
    fused and kernelized, paged and slot), else a ``drive`` here from
    the same seed; and every entry's TP=1 prefill logits on
    tp_logit_tokens."""
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M
    base = {}
    for run in TP_RUNS:
        key = tp_name(run[:3] + (1,) + run[4:])
        if key in base:
            continue
        arch, depth, dep, _, kw, dtype = run
        cfg, _ = tp_config(registry, run)
        params = M.materialize_params(cfg, seed=0, device=dev)
        if arch == "qwen3-0.6b" and depth is None and dtype is None \
                and not kw.get("chunk_prefill"):
            got = served[dep]          # phase 3: paged tokens == slot's
            line = got["slot_line" if kw.get("cache") == "slot" else "line"]
            base[key] = {"tokens": got["toks"], "launches": line["launches"]}
        else:
            got = drive(torch, epi, cfg, params, arch_prompts(np, cfg), dev,
                        **kw)
            base[key] = {"tokens": got.toks, "launches": got.launches}
        toks = torch.as_tensor(tp_logit_tokens(np, cfg), device=dev)
        logits, _ = M.prefill_fn(params, {"tokens": toks}, cfg,
                                 TS.make_engine(cfg))
        base[key]["logits"] = logits.float().cpu().numpy()
        del params, got
        release(torch)
    return base


def phase_serve_tp(torch, np, epi, registry, dev, card, served):
    """Tensor-parallel serving (TP_RUNS) through ``ServeEngine(mesh=)``:
    TP_WORLD spawned ranks (``launch/mesh.py::spawn_ranks``) share the
    card over TP_BACKEND. Against TP=1 (``tp_baselines``; the chunked
    run against TP=1 chunked, bf16 chunked tokens being another arithmetic
    than one-shot): every rank's logits and tokens bit-identical; the
    slot run's tokens equal the TP=2 paged run's; each rank's launches
    exact (``drive``), the same on every rank, by shape and variant, and
    equal to TP=1's; prefill logits within TP_F32_TOL / TP_BF16_TOL of
    TP=1's largest |logit|; at f32 TP=1's tokens (bf16: the agreement is
    printed). Each line
    prints the backend, each kernel's launches by shape, collectives per
    forward, peak memory per rank and both rates; qwen3's paged lines
    also the collectives and host syncs of one more TP decode chunk
    (gloo copies through the host: no gate; the zero-sync gate stays on
    TP=1). Every launch shape joins
    SERVED_SHAPES. Then the same ranks train (``phase_train_sharded``).
    Returns {line name: line} of both for phase 4's shape timings."""
    from repro_torch.launch import mesh as LM
    base = tp_baselines(torch, np, epi, registry, dev, served)
    release(torch)
    t0 = time.perf_counter()
    ranks = LM.spawn_ranks(_tp_rank, TP_WORLD, backend=TP_BACKEND,
                           device=dev, args=(TP_RUNS,))
    spawn_s = time.perf_counter() - t0
    lines, fails = {}, []
    for i, run in enumerate(TP_RUNS):
        arch, depth, dep, tp, kw, dtype = run
        cfg, full_layers = tp_config(registry, run)
        got = [r[i] for r in ranks if i in r]
        assert len(got) == tp, (run, len(got))
        name = tp_name(run)
        one = base[tp_name(run[:3] + (1,) + run[4:])]
        r0 = got[0]
        shapes = {k: n for k, n in r0["shapes"].items()}
        line = {"phase": name, "card": card, "arch": cfg.name,
                "layers": cfg.n_layers, "full_layers": full_layers,
                "deployment": dep, "compute_dtype": cfg.compute_dtype,
                "tp": tp, "backend": TP_BACKEND, "device": str(dev),
                "engine_kw": kw, "paged": r0["paged"],
                "chunked": r0["chunked"],
                "forwards": r0["forwards"],
                "prefill_batches": r0["prefill_batches"],
                "prefill_chunks": r0["prefill_chunks"],
                "decode_steps": r0["decode_steps"],
                "launches": r0["launches"], "launches_tp1": one["launches"],
                "launches_per_rank": [r["launches"] for r in got],
                "glu_variants": r0["variants"],
                "kernel_shapes": [[k, list(shape), dt, act, n]
                                  for (k, shape, dt, act, _), n in
                                  sorted(shapes.items(), key=repr)],
                "collectives": r0["collectives"],
                "collectives_per_forward": r0["collectives"]
                / r0["forwards"],
                "collective_mb": r0["collective_bytes"] / 1e6,
                "collectives_per_decode_step":
                    r0.get("collectives_per_decode_step"),
                "decode_chunk_host_syncs": [r.get("decode_chunk_host_syncs")
                                            for r in got],
                "max_memory_allocated_gb_per_rank":
                    [r["max_memory_allocated_gb"] for r in got],
                "local_weights_gb": r0["local_weights_gb"],
                "local_cache_gb": r0["local_cache_gb"],
                "decode_tokens_per_s": r0["decode_tokens_per_s"],
                "prefill_tokens_per_s": r0["prefill_tokens_per_s"],
                "rates_note": f"{tp} ranks through {TP_BACKEND} "
                              "(host-staged collectives) on one card that "
                              + ("the other TP 2 pair shares at once"
                                 if tp == 2 else "they share")
                              + ": information, not a speed claim",
                "tokens_identical_across_ranks": all(
                    r["tokens"] == r0["tokens"] for r in got),
                "tokens_identical_to_tp1": r0["tokens"] == one["tokens"],
                "spawn_s": spawn_s}
        if depth is not None:
            line["reduced"] = {"n_layers": [depth, full_layers]}
        if kw.get("cache") == "slot":
            paged2 = lines[tp_name(run[:4] + ({},) + run[5:])]
            line["tokens_identical_to_tp_paged"] = \
                r0["tokens"] == paged2["_tokens"]
        if kw.get("chunk_prefill"):
            paged2 = lines[tp_name(run[:4] + ({},) + run[5:])]
            line["token_agreement_vs_tp_one_shot"] = agreement(
                r0["tokens"], paged2["_tokens"])
        scale = float(np.abs(one["logits"]).max())
        diffs = [float(np.abs(r["logits"] - one["logits"]).max())
                 for r in got]
        line.update(token_agreement_vs_tp1=agreement(r0["tokens"],
                                                     one["tokens"]),
                    logits_max_abs_diff=max(diffs), logits_max_abs_tp1=scale,
                    logits_rel=max(diffs) / scale,
                    logits_identical_across_ranks=all(
                        np.array_equal(r["logits"], r0["logits"])
                        for r in got))
        f32 = dtype == "float32"
        line["tolerance_rel"] = TP_F32_TOL if f32 else TP_BF16_TOL
        emit(line)
        line["_tokens"] = r0["tokens"]
        lines[name] = line
        fails += [f"{name}: {what}" for what, ok in (
            ("tokens differ across ranks",
             line["tokens_identical_across_ranks"]),
            ("logits differ across ranks",
             line["logits_identical_across_ranks"]),
            ("f32 tokens != TP=1", not f32
             or line["tokens_identical_to_tp1"]),
            ("slot tokens != TP paged",
             line.get("tokens_identical_to_tp_paged", True)),
            ("launches != TP=1", all(r["launches"] == one["launches"]
                                     for r in got)),
            ("shapes differ across ranks", all(r["shapes"] == r0["shapes"]
                                               for r in got)),
            ("variants differ across ranks",
             all(r["variants"] == r0["variants"] for r in got)),
            ("no collective", r0["collectives"] > 0),
            ("logits off TP=1's", line["logits_rel"]
             <= line["tolerance_rel"])) if not ok]
        for key, n in shapes.items():
            SERVED_SHAPES[key] = SERVED_SHAPES.get(key, 0) + n
    for line in lines.values():
        del line["_tokens"]
    assert not fails, fails
    lines.update(phase_train_sharded(torch, registry, card, ranks))
    return lines


def phase_autotune_grid(torch, dev, card):
    """Every FULL_GRID candidate and the baseline scored on the card and
    on the CPU (``candidate_grid`` / ``candidate_of``: NAND2 gates, and
    the max error of the bit-accurate fixed datapath over the whole
    Q-format lattice): tags, gates and max_err equal bit for bit. Returns
    the card's (candidates, baseline)."""
    from repro_torch.core import autotune as AT
    got, secs = {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        got[str(where)] = (AT.candidate_grid(AT.FULL_GRID, device=where),
                           AT.candidate_of(AT.BASELINE_ACT, device=where))
        secs[str(where)] = time.perf_counter() - t0
    (cands, base), (cpu_cands, cpu_base) = got[str(dev)], got["cpu"]
    same = [(a.tag, a.gates, a.max_err) == (b.tag, b.gates, b.max_err)
            for a, b in zip(cands + [base], cpu_cands + [cpu_base])]
    emit({"phase": "autotune_grid", "card": card, "grid": "FULL_GRID",
          "candidates": [c.row() for c in cands], "baseline": base.row(),
          "cheaper_than_baseline": [c.tag for c in sorted(
              cands, key=lambda c: c.gates) if c.gates < base.gates],
          "card_equals_cpu": same, "seconds": secs})
    assert all(same), same
    return cands, base


def phase_autotune(torch, epi, registry, dev, card, cands, base):
    """The autotuner at full width on the card: ``train_smoke`` of
    AUTOTUNE_ARCH under the uniform baseline (in place), ``make_eval_fn``
    at the same batch and seq, ``greedy_assign`` over the grid. Gates: the
    assignment covers every layer, its loss is at most the baseline's,
    the final assignment evaluated again gives the same loss bits, and
    neither kernel launches in the training or the evaluations (a
    ``*_fixed`` datapath has no kernel). Returns (config, params,
    AutotuneResult)."""
    from repro_torch.core import autotune as AT
    cfg = dataclasses.replace(registry.get(AUTOTUNE_ARCH),
                              activation=AT.BASELINE_ACT)
    zero_launches(epi)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = AT.train_smoke(cfg, AUTOTUNE_STEPS, AUTOTUNE_BATCH,
                            AUTOTUNE_SEQ, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(epi.LAUNCHES)
    oracle = AT.make_eval_fn(cfg, params, batch=AUTOTUNE_BATCH,
                             seq=AUTOTUNE_SEQ, device=dev)
    evals = []

    def eval_fn(layer_cfgs):
        t = time.perf_counter()
        loss = oracle(layer_cfgs)
        evals.append(time.perf_counter() - t)
        return loss

    # one evaluation of the baseline ahead of the search, which the
    # search's own first evaluation must reproduce bit for bit
    first_loss = eval_fn((AT.BASELINE_ACT,) * cfg.n_layers)
    zero_launches(epi)
    logs = []
    t0 = time.perf_counter()
    res = AT.greedy_assign(eval_fn, cfg.n_layers, cands, base,
                           log=logs.append)
    search_s = time.perf_counter() - t0
    again = oracle(tuple(c.act for c in res.assignment))
    eval_launches = dict(epi.LAUNCHES)
    line = {"phase": f"autotune_{AUTOTUNE_ARCH}", "card": card,
            "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "compute_dtype": cfg.compute_dtype, "baseline": base.tag,
            "train": {"steps": AUTOTUNE_STEPS, "batch": AUTOTUNE_BATCH,
                      "seq": AUTOTUNE_SEQ, "seconds": train_s,
                      "launches": train_launches},
            "grid": "FULL_GRID", "candidates": len(cands),
            "assignment": [c.row() for c in res.assignment],
            "gates": res.gates, "base_gates": res.base_gates,
            "gates_saved_frac": 1.0 - res.gates / res.base_gates,
            "loss": res.loss, "base_loss": res.base_loss,
            "baseline_eval_before_search": first_loss,
            "loss_again": again, "same_loss_bits": again == res.loss,
            "evals": res.evals, "history": res.history, "log": logs,
            "eval_s": {"median": statistics.median(evals), "max": max(evals),
                       "sum": sum(evals), "n": len(evals)},
            "search_s": search_s, "eval_launches": eval_launches,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9}
    emit(line)
    assert len(res.assignment) == cfg.n_layers, res.assignment
    assert math.isfinite(res.base_loss) and res.loss <= res.base_loss, line
    assert first_loss == res.base_loss, (first_loss, res.base_loss)
    assert again == res.loss, (again, res.loss)
    assert not any(train_launches.values()), train_launches
    assert not any(eval_launches.values()), eval_launches
    return cfg, params, res


def phase_autotune_f32_vs_cpu(torch, cfg, params, res, dev, card):
    """The tuned assignment's eval loss at f32 (``eval_fn_of``, batch
    TRAIN_F32_BATCH x TRAIN_F32_SEQ from the eval pipeline's seed) on the
    card and on the CPU from the same weights: within AUTOTUNE_F32_TOL
    relative (see there)."""
    from repro_torch.core import autotune as AT
    from repro_torch.data import DataConfig, SyntheticPipeline
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    layer_cfgs = tuple(c.act for c in res.assignment)
    batch = SyntheticPipeline(cfg32, DataConfig(
        seed=1234, vocab_size=cfg.vocab_size), TRAIN_F32_BATCH,
        TRAIN_F32_SEQ, device="cpu")(0)
    got = {}
    for where, tree in ((dev, params), ("cpu", _tree_to(params, "cpu"))):
        got[str(where)] = AT.eval_fn_of(cfg32, tree, [
            {k: v.to(where) for k, v in batch.items()}])(layer_cfgs)
    a, b = got[str(dev)], got["cpu"]
    rel = abs(a - b) / abs(b)
    emit({"phase": "autotune_f32_vs_cpu", "card": card, "arch": cfg.name,
          "layers": cfg.n_layers, "batch": TRAIN_F32_BATCH,
          "seq": TRAIN_F32_SEQ, "assignment": [c.tag for c in
                                                res.assignment],
          "loss": {"card": a, "cpu": b}, "rel": rel,
          "tolerance_rel": AUTOTUNE_F32_TOL})
    assert rel <= AUTOTUNE_F32_TOL, (a, b, rel)


def phase_serve_autotuned(torch, np, epi, cfg, params, res, dev, card):
    """The tuned assignment served through the ServeEngine on the paged
    cache, on the main schedule's prompts (``phase_serve``: warm-up, then
    the counted run; every request MAX_NEW tokens in the vocabulary, every
    page back, no kernel launch: ``launches_per_forward`` is 0 under
    ``*_fixed``), then one decode chunk that must make no host sync."""
    from repro_torch.serve import EngineConfig, ServeEngine
    tuned = dataclasses.replace(cfg, act_impl="", act_layers=tuple(
        c.act for c in res.assignment))
    params = with_act(torch, params, tuned, dev)
    prompts = arch_prompts(np, tuned)
    phase_serve(torch, epi, f"serve_autotuned_{AUTOTUNE_ARCH}", tuned,
                params, prompts, dev, card,
                assignment=[c.tag for c in res.assignment],
                distinct_engines=len({c.tag for c in res.assignment}))
    eng = ServeEngine(tuned, params, EngineConfig(
        slots=SLOTS, max_prompt_len=MAX_PROMPT, max_len=MAX_LEN,
        chunk=CHUNK, page_size=PAGE_SIZE), device=dev)
    for pr in prompts[:SLOTS]:
        eng.submit(pr, max_new=MAX_NEW)
    eng.step()                          # admission + first decode chunk
    decode_chunk_sync_check(torch, tuned, eng)
    emit({"phase": f"serve_autotuned_{AUTOTUNE_ARCH}_sync", "card": card,
          "decode_chunk_host_syncs": 0})


def _as_meta(torch, tree):
    """Meta tensors of ``tree``'s shapes and types (other leaves kept)."""
    if isinstance(tree, dict):
        return {k: _as_meta(torch, v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def _calibrate(torch, H, RL, epi, name, fn, args, model_flops, card,
               gate_memory, warm_meta):
    """One step counted on the card's tensors and on meta tensors (after
    an uncounted call on the card, and with ``warm_meta`` one on meta: the
    parameter caches and cuBLAS warm; a model's caches on meta are filled
    by its first call), the counts held equal and the kernels to the
    launches; the roofline of the card's count against the step's wall
    (median of CALIB_WALL_STEPS unprofiled calls) and device busy time
    (one profiled call); the meta count's step peak against
    max_memory_allocated(). Emits the line."""
    from torch.profiler import ProfilerActivity, profile
    meta_args = _as_meta(torch, args)
    fn(*args)
    if warm_meta:
        fn(*meta_args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_launches(epi)
    got = H.count_step(fn, *args)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - before
    launches = {k: n for k, n in epi.LAUNCHES.items() if n}
    meta = H.count_step(fn, *meta_args)
    walls = []
    for _ in range(CALIB_WALL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    roof = RL.analyze(got, n_devices=1, model_flops=model_flops)
    bound = max(roof.compute_s, roof.memory_s, roof.collective_s) * 1e3
    mem = meta.memory
    line = {"phase": "roofline_calibration_" + name, "card": card,
            "flops_by_dtype": {"card": got.flops_by_dtype,
                               "meta": meta.flops_by_dtype},
            "bytes": {"card": got.bytes, "meta": meta.bytes},
            "kernels": {"card": got.kernels, "meta": meta.kernels,
                        "launches": launches},
            "transcendentals": got.transcendentals,
            "counts_equal": (got.flops_by_dtype, got.bytes, got.kernels) == (
                meta.flops_by_dtype, meta.bytes, meta.kernels),
            "compute_ms": roof.compute_s * 1e3,
            "memory_ms": roof.memory_s * 1e3,
            "collective_ms": roof.collective_s * 1e3,
            "bottleneck": roof.bottleneck, "bound_ms": bound,
            "wall_ms": wall, "walls_ms": walls, "device_busy_ms": busy,
            "wall_over_bound": wall / bound, "busy_over_bound": busy / bound,
            "model_flops": model_flops,
            "mfu": model_flops / (wall / 1e3 * RL.PEAK_FLOPS_BF16),
            "mfu_bound": roof.mfu_bound,
            "memory": {"argument_bytes": mem["argument_bytes"],
                       "peak_estimate_bytes": mem["argument_bytes"]
                       + mem["output_bytes"] + mem["temp_bytes"]
                       - mem["alias_bytes"],
                       "step_peak_meta": mem["peak_bytes"],
                       "step_peak_card_count": got.memory["peak_bytes"],
                       "allocated_before": before,
                       "max_memory_allocated": before + step_peak,
                       "step_peak_measured": step_peak,
                       "rel_err": mem["peak_bytes"] / step_peak - 1,
                       "tolerance": CALIB_MEM_TOL if gate_memory else None}}
    emit(line)
    assert line["counts_equal"], (name, line["flops_by_dtype"],
                                  line["bytes"], line["kernels"])
    assert got.kernels == meta.kernels == launches, line["kernels"]
    if gate_memory:
        assert abs(line["memory"]["rel_err"]) <= CALIB_MEM_TOL, \
            line["memory"]
    return line


def phase_roofline_calibration(torch, epi, base, weights, dev, card):
    """ROADMAP item 13 on the card: (a) qwen3-0.6b at full width, fused
    (glu_2d) and kernelized (elementwise_2d), one train step at TRAIN_BATCH
    x TRAIN_SEQ and one decode chunk counted on the card's tensors equal
    the same counted on meta tensors (FLOPs by class, bytes, kernels =
    the launches); (b) each count's roofline against the measured wall
    and busy time, and the MFU; (c) the meta count's peak of the train
    step against max_memory_allocated(), within CALIB_MEM_TOL; (d) the
    dry-run CLI in subprocesses on this host (DRYRUN_CLI, running while
    the card works): every DRYRUN_OK cell ok."""
    import os
    from repro_torch.analysis import hlo_cost as H
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs.common import act_impl_of, fused_of
    from repro_torch.launch import shapes as SH
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import make_decode_chunk
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--force", "--tag", DRYRUN_TAG], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for argv in DRYRUN_CLI]
    try:
        lines = {}
        for dep, cfg in (("fused", fused_of(base)),
                         ("kernelized", act_impl_of(base, "cr_spline",
                                                    use_kernel=True))):
            # the decode chunk first: its meta call warms the model's
            # caches on meta for both steps
            params = with_act(torch, weights, cfg, dev)
            serve = M.compute_params(params, cfg)
            cache = M.init_cache(cfg, SLOTS, MAX_LEN, per_slot=True,
                                 device=dev)
            state = {"tok": torch.zeros((SLOTS,), dtype=torch.int32,
                                        device=dev),
                     "emitted": torch.zeros((SLOTS,), dtype=torch.int32,
                                            device=dev),
                     "active": torch.ones((SLOTS,), dtype=torch.bool,
                                          device=dev),
                     "budget": torch.full((SLOTS,), 10 ** 6,
                                          dtype=torch.int32, device=dev),
                     "eos": torch.full((SLOTS,), -1, dtype=torch.int32,
                                       device=dev)}
            chunk = make_decode_chunk(cfg, CHUNK)
            lines[dep + "_decode"] = _calibrate(
                torch, H, RL, epi, dep + "_decode_chunk", chunk,
                (serve, cache, state, 0, [0, 1], [0, 0], [0.0, 0.0]),
                CHUNK * RL.model_flops_for(cfg, SH.ShapeCell(
                    "decode", MAX_LEN, SLOTS, "decode")), card, False, True)
            del serve, cache, state
            opt = adamw.init_state(params)
            batch = train_pipe(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)(0)
            step = TS.make_train_step(cfg, TS.TrainHyper(opt=train_opt()))
            lines[dep + "_train"] = _calibrate(
                torch, H, RL, epi, dep + "_train", step,
                (params, opt, batch, 1), RL.model_flops_for(cfg, SH.ShapeCell(
                    "train", TRAIN_SEQ, TRAIN_BATCH, "train")), card, True,
                False)
            del opt, batch, step, params
            release(torch)
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cells = {}
    for arch, shape, mesh in DRYRUN_OK:
        path = (ROOT / "experiments" / "dryrun_torch"
                / f"{arch}__{shape}__{mesh}__{DRYRUN_TAG}.json")
        res = json.loads(path.read_text()) if path.exists() else {
            "status": "missing"}
        cells[f"{arch} x {shape} x {mesh}"] = {
            k: res.get(k) for k in ("status", "count_s", "error")} | {
            "bottleneck": res.get("roofline", {}).get("bottleneck"),
            "mfu_bound": res.get("roofline", {}).get("mfu_bound"),
            "peak_estimate_gb": res.get("memory", {}).get(
                "peak_estimate_bytes", 0) / 1e9}
    emit({"phase": "roofline_calibration_dryrun_cli", "card": card,
          "returncodes": [p.returncode for p in procs], "cells": cells,
          "tails": [o[-800:] for o in outs]})
    assert all(c["status"] == "ok" for c in cells.values()), cells
    assert all(p.returncode == 0 for p in procs), outs
    emit({"phase": "roofline_calibration", "card": card,
          "seconds": time.perf_counter() - t0})
    return lines


def phase_examples(torch, epi, dev, card):
    """The four examples/torch_*.py on the card, in-process through their
    ``main(argv)`` (EXAMPLE_RUNS, ``--device`` added; train_lm into a
    temporary ``--ckpt-dir``, twice: the second run must resume at the
    first's last step), each finishing without an assertion. Their
    output is kept off this script's stdout (its last line printed);
    each run's seconds and each kernel's launches during it."""
    import contextlib
    import importlib.util
    import io
    import tempfile
    runs = []
    with tempfile.TemporaryDirectory() as ckpt:
        for name, argv in EXAMPLE_RUNS:
            spec = importlib.util.spec_from_file_location(
                f"_example_{name}", ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            argv = list(argv) + ["--device", str(dev)] + (
                ["--ckpt-dir", ckpt] if name == "torch_train_lm" else [])
            zero_launches(epi)
            out = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    got = mod.main(argv)
            except BaseException:
                print(out.getvalue(), file=sys.stderr, flush=True)
                raise
            torch.cuda.synchronize()
            run = {"example": name, "argv": argv,
                   "seconds": time.perf_counter() - t0,
                   "launches": dict(epi.LAUNCHES),
                   "last_line": out.getvalue().rstrip().splitlines()[-1]}
            if name == "torch_train_lm":
                run["summary"] = got
                n = sum(r["example"] == name for r in runs)
                # the second run resumes at the first's last step and
                # trains no more
                steps = int(argv[argv.index("--steps") + 1])
                assert got["steps"] == steps and got["skipped"] == 0, got
                assert (got["loss_first"] is None) == (n == 1), got
            runs.append(run)
    emit({"phase": "examples", "card": card, "runs": runs,
          "note": "torch_activation_ablation trains through the engines' "
                  "plain routes (no use_kernel, no fused FFN): no kernel "
                  "launches, as in the reference's"})
    quick = runs[0]
    assert quick["launches"] == {"elementwise_2d": 1, "glu_2d": 0}, quick
    assert not any(runs[-1]["launches"].values()), runs[-1]


def with_act(torch, params, cfg, device):
    """``params`` with the ``act`` leaf of ``cfg``'s scheme: the weights
    are shared, only the approximant params differ between schemes."""
    from repro_torch.core.activations import init_act_params
    out = {k: v for k, v in params.items() if k != "act"}
    out["act"] = {tag: torch.as_tensor(arr, device=device) for tag, arr in
                  init_act_params(cfg.layer_activation_configs()).items()}
    return out


def first_layers(params, n):
    """``params`` with only the first ``n`` layers of its stacked blocks
    (views)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    return dict(params, blocks=cut(params["blocks"]))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    t_start = time.perf_counter()
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
    phase_grouped_mm(torch, dev)

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
        for kind, kernel in (("fused", "glu_2d"),
                             ("kernelized", "elementwise_2d")):
            name, build = scheme_dep(kind, scheme)
            deployments.append((name, scheme, kernel, build(base)))
    weights = M.materialize_params(base, seed=0, device=dev)
    served = {}
    for name, scheme, _, cfg in deployments:
        params = with_act(torch, weights, cfg, dev)
        # the two caches run in turns, paged first in every other
        # deployment, so neither always meets a colder host
        order = ("paged", "slot") if len(served) % 2 == 0 \
            else ("slot", "paged")
        runs = {cache: phase_serve(torch, epi, "serve_" + name, cfg, params,
                                   prompts, dev, card, cache)
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
    for name, scheme, _, cfg in deployments:
        if scheme == "cr_spline":
            phase_prefix(torch, epi, name, cfg, weights, dev, card)
            phase_chunked(torch, epi, name, cfg, weights, prompts, dev, card,
                          served[name]["toks"])
    # train the cr_spline pair at full width, also before any profiling,
    # then cr_fixed (quantization-aware: the straight-through gradient)
    trained = {name: phase_train(torch, epi, name, cfg, weights, dev, card)
               for name, scheme, _, cfg in deployments
               if scheme == "cr_spline"}
    fixed_deps = [(f"fixed_{scheme}", impl, act_impl_of(base, impl))
                  for scheme, impl in zip(SCHEMES, FIXED_IMPLS)]
    _, fixed_train, fixed_train_cfg = fixed_deps[0]       # cr_fixed
    fixed_trained = phase_train(torch, epi, fixed_train, fixed_train_cfg,
                                weights, dev, card, runs=FIXED_TRAIN_RUNS)
    torch.cuda.empty_cache()
    # serve under each bit-accurate integer datapath: no kernel launches
    for name, _, cfg in fixed_deps:
        params = with_act(torch, weights, cfg, dev)
        _, _, line = phase_serve(torch, epi, "serve_" + name, cfg, params,
                                 prompts, dev, card)
        served[name] = dict(line=line, params=params)

    # 3b. the dense and MoE archs at full width (depth cut where the model
    #     does not fit), then qwen3-0.6b under per-layer assignments, also
    #     before any profiling
    release(torch)
    arch_lines = phase_archs(torch, np, epi, registry, dev, card)
    per_layer = phase_per_layer(torch, epi, base, weights, prompts, dev,
                                card, served["kernelized"]["toks"])
    release(torch)
    # 3c. train the families the card had not trained (ROADMAP item 9b)
    train_arch_lines = phase_train_archs(torch, epi, registry, dev, card)
    release(torch)
    # 3d. the multi-replica tier (ROADMAP item 10): routed, backpressure,
    #     autoscale, and an engine in a spawned worker
    routed_line = phase_routed(torch, np, epi, fused_of(base), weights, dev,
                               card)
    phase_process_replica(torch, np, base, dev, card)
    release(torch)
    # 3d'. tensor-parallel serving (ROADMAP item 12): TP_WORLD ranks share
    #      the card over gloo; their launch shapes are timed in phase 4
    arch_lines.update(phase_serve_tp(torch, np, epi, registry, dev, card,
                                     served))
    release(torch)
    # 3e. the autotuner at full width on the card (ROADMAP item 11), its
    #     assignment served, and the four examples
    cands, baseline = phase_autotune_grid(torch, dev, card)
    tuned_cfg, tuned_params, tuned = phase_autotune(
        torch, epi, registry, dev, card, cands, baseline)
    phase_serve_autotuned(torch, np, epi, tuned_cfg, tuned_params, tuned,
                          dev, card)
    phase_autotune_f32_vs_cpu(torch, tuned_cfg, tuned_params, tuned, dev,
                              card)
    del tuned_params
    release(torch)
    phase_examples(torch, epi, dev, card)
    release(torch)
    # both kernels against their plain versions at every shape the
    # counted served runs launched them at
    phase_kernel_checks_served(torch, epi, dev, worst)
    release(torch)
    # 3f. the dry run's counts held against the card (ROADMAP item 13),
    #     the last phase before any profiler session but its own
    phase_roofline_calibration(torch, epi, base, weights, dev, card)
    release(torch)

    # 4. kernel timings, then where a decode step's time goes
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    t_times = time.perf_counter()
    timings = phase_kernel_times(torch, epi, dev, flush, arch_lines)
    elementwise_aims(timings)
    glu_f32_aims(timings, time.perf_counter() - t_times,
                 torch.backends.cuda.matmul.allow_tf32)
    glu_bf16_aims(epi, timings)
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
    release(torch)
    for dep, (cfg, line) in per_layer.items():
        phase_trace(torch, "per_layer_" + dep, cfg,
                    with_act(torch, weights, cfg, dev), prompts, dev, line,
                    "paged")
    phase_arch_traces(torch, np, registry, dev, arch_lines)
    release(torch)
    phase_train_arch_traces(torch, registry, dev, train_arch_lines)
    release(torch)

    # 5. f32 prefill logits: card (kernels) vs CPU (plain versions)
    f32_before = dict(epi.GLU_VARIANTS)
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
    # one f32 train step: card (kernels) vs CPU (plain versions), at the
    # first ARCH_F32_LAYERS layers
    n = ARCH_F32_LAYERS[base.name]
    cut, cut_cpu = first_layers(weights, n), first_layers(weights_cpu, n)
    for name, _, _, cfg in deployments:
        if name in trained:
            phase_train_f32_vs_cpu(torch, M, TS, name, dataclasses.replace(
                cfg, n_layers=n), cut, cut_cpu, dev, tol)
    phase_train_f32_vs_cpu(torch, M, TS, fixed_train, dataclasses.replace(
        fixed_train_cfg, n_layers=n), cut, cut_cpu, dev, FIXED_F32_TOL)
    del cut, cut_cpu
    # the fused per-layer assignment: each layer's glu_2d launch reads its
    # own scheme's params
    cfg = per_layer["fused"][0]
    diff, scale = phase_f32_vs_cpu(torch, np, M, TS, cfg, weights,
                                   weights_cpu, dev)
    emit({"phase": "f32_vs_cpu", "deployment": "per_layer_fused", "layers":
          cfg.n_layers, "max_abs_diff": diff, "max_abs_logit": scale,
          "rel": diff / scale, "tolerance_rel": tol})
    assert diff / scale <= tol, ("per_layer_fused", diff / scale)
    del weights, weights_cpu
    release(torch)
    # every new arch at f32, card against CPU (MoE: routing identical)
    phase_arch_f32_vs_cpu(torch, np, epi, registry, dev, card)
    # each arch train run's loss and gradient at f32, card against CPU
    phase_train_arch_f32_vs_cpu(torch, epi, ops, registry, dev, card)
    f32_glu_variants(epi, f32_before, "f32_vs_cpu")

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
        # qwen3's cr_spline pair trains in phase 3, the other schemes in
        # 3c: the run of this scheme that launched this kernel
        own_train = trained.get(name) or next(
            (ln for ln in train_arch_lines.values() if ln["scheme"] == scheme
             and any(run["launches"][kernel] for run in ln["runs"].values())),
            None)
        if own_train:
            kernels[-1]["train_launches"] = {
                remat: run["launches"][kernel]
                for remat, run in own_train["runs"].items()}
        if scheme == "cr_spline":
            # the dense and MoE archs' shapes, and the launches of this
            # kernel in each of their runs and the per-layer runs
            kernels[-1]["by_shape"] = {
                key[2]: {k: timings[key].get(k) for k in by_keys[kernel]}
                for key in timings
                if key[0] == kernel and isinstance(key[2], str)}
            kernels[-1]["arch_launches"] = {
                run: line["launches"][kernel]
                for run, line in list(arch_lines.items())
                + [("serve_per_layer_" + d, ln)
                   for d, (_, ln) in per_layer.items()]}
            if kernel == "glu_2d":
                kernels[-1]["routed_launches"] = routed_line["launches"][kernel]
            kernels[-1]["train_arch_launches"] = {
                line["phase"]: {remat: run["launches"][kernel]
                                for remat, run in line["runs"].items()}
                for line in train_arch_lines.values()
                if line["scheme"] in ("cr_spline", "per_layer")}
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start,
          "card": card})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
