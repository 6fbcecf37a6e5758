"""End-to-end training launcher (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run0 \\
        [--device cpu]

Wires together: config registry -> parameters on one device -> synthetic
data pipeline -> fault-guarded train step -> TrainDriver
(checkpoint/restart, NaN rollback, straggler watchdog). Re-running the
same command resumes from the latest committed checkpoint. The weights
are random from torch's generator (``materialize_params``) and the data
from the port's pipeline; neither matches the reference's ``jax.random``
draws.

The flags and defaults are the reference's, but ``--arch``, whose
default ``olmo-1b`` waits for its family (ROADMAP.md, Queue A item 9),
and ``--device`` (default cuda). The port trains on one device:
``--data-parallel`` (0 = every device: the one) and ``--model-parallel``
other than 1 raise (Queue A item 12), as does ``--act-layers`` (item 9).
``--activation cr_fixed`` (or ``pwl_fixed`` / ``poly_fixed`` /
``rational_fixed``, or ``--act-impl <scheme>_fixed``) trains through the
bit-accurate integer datapath with its straight-through gradient
(quantization-aware training).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.ft import FTConfig, TrainDriver
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.optim import adamw, compress


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen3-0.6b",
                   help="registry id (see repro_torch.configs.registry)")
    p.add_argument("--smoke", action="store_true",
                   help="reduced config of the same family (CPU-friendly)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8, help="global batch")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--activation", default=None,
                   help="override activation impl: exact|cr|cr_fixed|pwl|...")
    p.add_argument("--act-impl", default=None,
                   help="approximant scheme override (cr_spline|pwl|poly|"
                        "rational|<scheme>_fixed) — validated at step build; "
                        "--act-impl-kernel routes it through the epilogue "
                        "kernels")
    p.add_argument("--act-impl-kernel", action="store_true",
                   help="with --act-impl: use_kernel=True (one kernel "
                        "launch per nonlinearity)")
    p.add_argument("--act-layers", default=None,
                   help="per-layer approximant assignment (not ported)")
    p.add_argument("--train-act", action="store_true",
                   help="unfreeze the approximant params (knots / "
                        "coefficients)")
    p.add_argument("--remat", default="none",
                   choices=["none", "block", "dots"])
    p.add_argument("--grad-compression", action="store_true")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="data axis size (0 = all devices: the one device)")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--metrics-out", default=None,
                   help="write final metrics JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.data_parallel not in (0, 1) or args.model_parallel != 1:
        raise NotImplementedError(
            "--data-parallel / --model-parallel: the port trains on one "
            "device; sharded training is not ported yet (ROADMAP.md, Queue A "
            "item 12)")
    if args.act_layers:
        raise NotImplementedError(
            "--act-layers: per-layer approximant assignments are not ported "
            "yet (ROADMAP.md, Queue A item 9)")
    cfg = registry.get(args.arch, smoke=args.smoke)
    if args.activation:
        cfg = dataclasses.replace(
            cfg, activation=dataclasses.replace(cfg.activation,
                                                impl=args.activation))
    if args.act_impl_kernel and not args.act_impl:
        raise SystemExit("--act-impl-kernel requires --act-impl <scheme>")
    if args.act_impl:
        from repro_torch.configs.common import act_impl_of
        cfg = act_impl_of(cfg, args.act_impl,
                          use_kernel=True if args.act_impl_kernel else None)
    device = torch.device(args.device)
    print(f"[train] arch={cfg.name} act={cfg.activation.tag()} "
          f"device={device}")

    hyper = steps_mod.TrainHyper(
        opt=adamw.AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup,
                              decay_steps=max(args.steps, 2 * args.warmup)),
        remat=args.remat, grad_compression=args.grad_compression,
        train_act=args.train_act)
    step_fn = steps_mod.make_train_step(cfg, hyper)

    params = M.materialize_params(cfg, seed=args.seed, device=device)
    opt_state = adamw.init_state(params)
    if hyper.grad_compression:
        opt_state["error"] = compress.init_error(params)
    pipe = SyntheticPipeline(
        cfg, DataConfig(seed=args.seed + 1,
                        vocab_size=min(cfg.vocab_size, 4096)),
        args.batch, args.seq, device=device)

    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                  log_every=args.log_every)
    drv = TrainDriver.resume(step_fn, pipe, params, opt_state, ft,
                             metadata={"arch": cfg.name,
                                       "activation": cfg.activation.tag()})
    t0 = time.time()
    remaining = max(0, args.steps - drv.step)
    drv.run(remaining)
    wall = time.time() - t0
    drv.save()

    losses = drv.losses()
    tokens = remaining * args.batch * args.seq
    summary = {
        "arch": cfg.name,
        "activation": cfg.activation.tag(),
        "steps": int(drv.step),
        "loss_first": float(losses[0]) if len(losses) else None,
        "loss_last_avg8": float(losses[-8:].mean()) if len(losses) else None,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(tokens / wall, 1) if wall > 0 else None,
        "stragglers": int(sum(r.straggler for r in drv.history)),
        "skipped": int(sum(r.skipped for r in drv.history)),
    }
    print("[train] done:", json.dumps(summary, indent=1))
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
