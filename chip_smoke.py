#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100), ``nvcc`` and PyTorch built for
CUDA. It imports nothing of JAX and nothing of the JAX package. Phases,
each printing one JSON line:

  1. build: compile both hand-written kernels from src/repro_torch/csrc
     with nvcc; print the card's name and power limit; TF32 off.
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at stated tolerances.
  3. serve ``fused_of(qwen3-0.6b)`` at full width (28 layers, random
     weights from seed 0, bf16 compute) through the port's ServeEngine:
     every FFN goes through ``glu_2d``; the launch count must be exactly
     28 x (prefills + decode steps), and ``elementwise_2d`` must not run.
  4. the same requests and weights under ``act_impl_of(qwen3-0.6b,
     "cr_spline", use_kernel=True)``: every FFN SiLU goes through
     ``elementwise_2d`` (exact count), ``glu_2d`` must not run.
  5. kernel timings at the main path's shapes, beside the bound from the
     card's data-sheet rates, the plain version and the library yardstick
     (``ms`` / ``plain_ms`` / ``library_ms``: device time from a profiler
     trace, the sum of one call's kernel durations, mean of 30 calls with
     L2 flushed before each; ``call_ms``: median time between CUDA events
     around one call, host dispatch included). Then one decode chunk of
     each deployment under the profiler: device busy time and idle share
     per decode step; and one decode chunk that must make no host sync
     (CUDA's sync debug mode raises on any). Profiling comes after serving because a profiled
     process keeps paying tracing costs on every later launch.
  6. f32 prefill logits of both deployments on the card (kernels) against
     the CPU (plain versions) on the same weights.
  7. the ``{"kernels": [...]}`` line.

Then the card's ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises, exits non-zero and
prints no ok line.
"""
from __future__ import annotations

import dataclasses
import json
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
# f32 operations of one silu epilogue element (csrc/epilogue.cu: index
# split 6, basis 22, MAC 7, saturate/sign 4, silu wiring 4)
EPILOGUE_OPS = 43

SLOTS, MAX_PROMPT, MAX_LEN, CHUNK = 2, 128, 160, 8
PROMPT_LENS = (17, 40, 64, 100)
MAX_NEW = 16


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


def device_ms(fn, flush, iters: int = 30):
    """Mean device time of one call: the sum of its kernels' (and copies')
    durations in a profiler trace, L2 flushed before each call; the
    flush's own kernels are left out by name. None if the trace holds no
    device activity."""
    flush_names = {n for n, _ in device_events(flush.zero_, 3)}
    evs = device_events(lambda: (flush.zero_(), fn()), iters)
    own = [us for n, us in evs if n not in flush_names]
    return sum(own) / iters / 1e3 if own else None


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp_ok(got, ref) -> bool:
    import torch
    a = ref.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return bool(((got.float() - ref.float()).abs() <= ulp).all())


def _silu_spec(torch, epi, dev):
    table = epi.table_for("silu", 4.0, 32)
    return epi.TableSpec.of(table), torch.as_tensor(
        table.windows, dtype=torch.float32, device=dev)


def phase_kernel_checks(torch, epi, dev):
    """Each kernel against its plain version on the card; returns the
    worst absolute error per kernel."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {"elementwise_2d": 0.0, "glu_2d": 0.0}
    for act in epi.EPILOGUES:
        table = epi.table_for(act, 4.0, 32)
        spec = epi.TableSpec.of(table)
        p = torch.as_tensor(table.windows, dtype=torch.float32, device=dev)
        cases = [((256, 3072), torch.float32), ((4, 3072), torch.float32),
                 ((37, 1000), torch.float32), ((256, 3072), torch.bfloat16)]
        for shape, dt in cases:
            x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dt)
            y = epi.elementwise_2d(x, p, spec=spec, act=act)
            torch.cuda.synchronize()
            yp = epi.elementwise_2d_plain(x, p, spec=spec, act=act)
            err = float((y.float() - yp.float()).abs().max())
            if dt == torch.float32:
                torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-6)
            elif not bf16_ulp_ok(y, yp):
                raise AssertionError(f"elementwise_2d {act} bf16 beyond one "
                                     f"ulp: max err {err}")
            worst["elementwise_2d"] = max(worst["elementwise_2d"], err)
            emit({"phase": "kernel_check", "kernel": "elementwise_2d",
                  "act": act, "shape": list(shape), "dtype": str(dt),
                  "max_abs_err": err})

    spec, p = _silu_spec(torch, epi, dev)
    K, N = 1024, 3072
    for M in (4, 256, 37):
        for dt, tol in ((torch.bfloat16, (1e-2, 1e-3)),
                        (torch.float32, (1e-4, 1e-5))):
            x = torch.randn((M, K), generator=gen, device=dev).to(dt)
            wg = (torch.randn((K, N), generator=gen, device=dev)
                  / K ** 0.5).to(dt)
            wu = (torch.randn((K, N), generator=gen, device=dev)
                  / K ** 0.5).to(dt)
            y = epi.glu_2d(x, wg, wu, p, spec=spec, act="silu")
            torch.cuda.synchronize()
            yp = epi.glu_2d_plain(x, wg, wu, p, spec=spec, act="silu")
            torch.testing.assert_close(y.float(), yp.float(), rtol=tol[0],
                                       atol=tol[1])
            err = float((y.float() - yp.float()).abs().max())
            worst["glu_2d"] = max(worst["glu_2d"], err)
            emit({"phase": "kernel_check", "kernel": "glu_2d", "act": "silu",
                  "shape": [M, K, N], "dtype": str(dt), "max_abs_err": err})
    return worst


def phase_kernel_times(torch, epi, dev, flush):
    """Kernel, plain version and library yardstick at the main path's
    shapes (bf16): decode rows = SLOTS, and the longest prefill (one
    128-token bucket). All per-call event times are taken before the
    first profiler session: a profiled process keeps paying per-launch
    tracing costs afterwards."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    spec, p = _silu_spec(torch, epi, dev)
    K, N = 1024, 3072
    cases = {}
    for rows in (SLOTS, MAX_PROMPT):
        x = torch.randn((rows, N), generator=gen, device=dev).to(torch.bfloat16)
        b_ms, b_by = bound(2 * x.numel() * 2 + p.numel() * 4,
                           EPILOGUE_OPS * x.numel(), F32_FLOPS)
        cases[("elementwise_2d", rows)] = dict(
            shape=[rows, N], bound=(b_ms, b_by), fns={
                "kernel": lambda x=x: epi.elementwise_2d(x, p, spec=spec,
                                                         act="silu"),
                "plain": lambda x=x: epi.elementwise_2d_plain(
                    x, p, spec=spec, act="silu")})
        xg = torch.randn((rows, K), generator=gen, device=dev).to(torch.bfloat16)
        wg = (torch.randn((K, N), generator=gen, device=dev)
              / K ** 0.5).to(torch.bfloat16)
        wu = (torch.randn((K, N), generator=gen, device=dev)
              / K ** 0.5).to(torch.bfloat16)
        nbytes = (xg.numel() + wg.numel() + wu.numel() + rows * N) * 2 \
            + p.numel() * 4
        cases[("glu_2d", rows)] = dict(
            shape=[rows, K, N],
            bound=bound(nbytes, 4.0 * rows * N * K, BF16_TC_FLOPS), fns={
                "kernel": lambda a=(xg, wg, wu): epi.glu_2d(*a, p, spec=spec),
                "plain": lambda a=(xg, wg, wu): epi.glu_2d_plain(*a, p,
                                                                 spec=spec),
                "library": lambda a=(xg, wg, wu): (torch.matmul(a[0], a[1]),
                                                   torch.matmul(a[0], a[2]))})
    calls = {(key, role): call_ms(fn, flush)
             for key, c in cases.items() for role, fn in c["fns"].items()}
    timings = {}
    for key, c in cases.items():
        fns = c["fns"]
        dev_ms = {role: device_ms(fn, flush) for role, fn in fns.items()}
        how = "profiler" if dev_ms["kernel"] is not None else "events"
        if how == "events":          # the trace held no device activity
            dev_ms = {role: calls[(key, role)] for role in fns}
        err = float((fns["kernel"]().float() - fns["plain"]().float())
                    .abs().max())
        t = dict(shape=c["shape"], dtype="bfloat16", max_abs_err=err,
                 ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                 bound_ms=c["bound"][0], bound_by=c["bound"][1],
                 library_ms=dev_ms.get("library"), timing=how,
                 call_ms=calls[(key, "kernel")],
                 plain_call_ms=calls[(key, "plain")],
                 library_call_ms=calls.get((key, "library")))
        timings[key] = t
        emit({"phase": "kernel_time", "kernel": key[0],
              "where": "decode" if key[1] == SLOTS else "prefill", **t})
    return timings


def serve(torch, cfg, params, prompts, dev):
    from repro_torch.serve import EngineConfig, ServeEngine
    ecfg = EngineConfig(slots=SLOTS, max_prompt_len=MAX_PROMPT,
                        max_len=MAX_LEN, chunk=CHUNK, cache="slot")
    eng = ServeEngine(cfg, params, ecfg, device=dev)
    for pr in prompts:
        eng.submit(pr, max_new=MAX_NEW)
    done = eng.run()
    return done, eng


def phase_serve(torch, epi, name, cfg, params, prompts, dev, card, kernel):
    """Warm up, then drive the main path with the launch counts zeroed
    just before and read just after."""
    serve(torch, cfg, params, prompts[:1], dev)            # warm-up
    for k in epi.LAUNCHES:
        epi.LAUNCHES[k] = 0
    done, eng = serve(torch, cfg, params, prompts, dev)
    launches = dict(epi.LAUNCHES)
    st = eng.stats
    forwards = st.prefill_batches + st.decode_steps
    assert len(done) == len(prompts), done
    for c in done:
        assert len(c.tokens) == MAX_NEW and c.finish_reason == "length", c
        assert all(0 <= t < cfg.padded_vocab for t in c.tokens), c.tokens
    other = "elementwise_2d" if kernel == "glu_2d" else "glu_2d"
    assert launches[kernel] == cfg.n_layers * forwards, (launches, forwards)
    assert launches[other] == 0, launches
    line = {"phase": name, "card": card, "requests": len(done),
          "prefill_batches": st.prefill_batches,
          "decode_steps": st.decode_steps, "launches": launches,
          "prefill_tokens": st.prefill_tokens, "prefill_s": st.prefill_s,
          "insert_s": st.insert_s, "decode_tokens": st.decode_tokens,
          "decode_s": st.decode_s,
          "prefill_tokens_per_s": st.prefill_tokens_per_s,
          "decode_tokens_per_s": st.decode_tokens_per_s}
    emit(line)
    return [c.tokens for c in done], launches, line


def phase_trace(torch, name, cfg, params, prompts, dev, serve_line):
    """Where a decode step's time goes: one decode chunk of the same
    engine under the profiler (device activity only). Device busy time
    per step against the unprofiled wall time per step of the main run
    gives the device's idle share; the repro kernels' share is the FFN
    kernel's part. Then one more decode chunk under CUDA's sync debug
    mode, which fails the run if the chunk makes the host wait."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.engine import make_decode_chunk
    eng = ServeEngine(cfg, params, EngineConfig(
        slots=SLOTS, max_prompt_len=MAX_PROMPT, max_len=MAX_LEN,
        chunk=CHUNK, cache="slot"), device=dev)
    for pr in prompts[:SLOTS]:
        eng.submit(pr, max_new=MAX_NEW)
    eng.step()                          # admission + first decode chunk
    steps0 = eng.stats.decode_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step()                      # one decode chunk, ends at a sync
    steps = eng.stats.decode_steps - steps0
    # a decode chunk enqueues all its steps without one host sync: any
    # sync inside (a copy from host memory, .item(), ...) raises here
    chunk = make_decode_chunk(cfg, CHUNK)
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
    out = {"phase": "trace_" + name, "decode_steps": steps,
           "decode_chunk_host_syncs": 0,
           "wall_ms_per_step": wall_step * 1e3, "device_events": len(evs)}
    if evs and steps:
        busy = sum(us for _, us in evs) / steps / 1e3
        mine = sum(us for n, us in evs if "repro_" in n) / steps / 1e3
        out.update(device_busy_ms_per_step=busy,
                   device_idle_share=1.0 - busy / (wall_step * 1e3),
                   repro_kernel_ms_per_step=mine,
                   kernels_per_step=len(evs) / steps)
    emit(out)


def phase_f32_vs_cpu(torch, np, M, TS, cfg, dev):
    """One ragged f32 prefill on the card (kernels) and on the CPU (plain
    versions), same weights; returns the relative max-norm difference."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = M.materialize_params(cfg32, seed=0, device=dev)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    lens = [40, 23]
    out = {}
    for where in (dev, "cpu"):
        p = M.compute_params(
            params if where == dev else _tree_to(params, "cpu"), cfg32)
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

    # 2. kernels against their plain versions
    worst = phase_kernel_checks(torch, epi, dev)

    # 3./4. serve qwen3-0.6b at full width through each kernel, before
    #       any profiler session (see phase_kernel_times)
    base = registry.get("qwen3-0.6b")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, base.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    cfg_f = fused_of(base)
    cfg_k = act_impl_of(base, "cr_spline", use_kernel=True)
    params_f = M.materialize_params(cfg_f, seed=0, device=dev)
    toks_f, launches_f, line_f = phase_serve(
        torch, epi, "serve_fused", cfg_f, params_f, prompts, dev, card,
        "glu_2d")
    params_k = M.materialize_params(cfg_k, seed=0, device=dev)
    toks_k, launches_k, line_k = phase_serve(
        torch, epi, "serve_kernelized", cfg_k, params_k, prompts, dev, card,
        "elementwise_2d")
    same = sum(a == b for ra, rb in zip(toks_f, toks_k)
               for a, b in zip(ra, rb))
    emit({"phase": "token_agreement", "fused_vs_kernelized": same
          / sum(len(r) for r in toks_f),
          "note": "bf16 deployments differ by design; information only"})

    # 5. kernel timings, then where a decode step's time goes
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = phase_kernel_times(torch, epi, dev, flush)
    phase_trace(torch, "fused", cfg_f, params_f, prompts, dev, line_f)
    phase_trace(torch, "kernelized", cfg_k, params_k, prompts, dev, line_k)
    del params_f, params_k, flush
    torch.cuda.empty_cache()

    # 6. f32 prefill logits: card (kernels) vs CPU (plain versions)
    tol = 1e-4
    for name, cfg in (("fused", cfg_f), ("kernelized", cfg_k)):
        diff, scale = phase_f32_vs_cpu(torch, np, M, TS, cfg, dev)
        rel = diff / scale
        emit({"phase": "f32_vs_cpu", "deployment": name, "layers":
              cfg.n_layers, "max_abs_diff": diff, "max_abs_logit": scale,
              "rel": rel, "tolerance_rel": tol})
        assert rel <= tol, (name, rel)

    # 7. the kernels line (timings at the decode shape, the main path's
    #    most frequent launch)
    kernels = []
    for name, line, launches in (("elementwise_2d", 229, launches_k),
                                 ("glu_2d", 289, launches_f)):
        t = timings[(name, SLOTS)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/epilogue.cu",
            "replaces": f"src/repro/kernels/epilogue.py:{line}",
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "dtype": t["dtype"], "timing": t["timing"],
            "call_ms": t["call_ms"], "max_abs_err_checks": worst[name]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
