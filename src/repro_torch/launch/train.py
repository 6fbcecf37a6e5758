"""End-to-end training launcher (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run0 \\
        [--act-layers pwl-d16,cr-d32] [--device cpu] \\
        [--data-parallel 2 --model-parallel 2 --dist-backend gloo]

Wires together: config registry -> parameters (a rank's blocks of them
on a mesh) -> synthetic data pipeline -> fault-guarded train step ->
TrainDriver (checkpoint/restart, NaN rollback, straggler watchdog).
Re-running the same command resumes from the latest committed
checkpoint, whatever the mesh that wrote it. The weights are random from
torch's generator (``materialize_params``) and the data from the port's
pipeline; neither matches the reference's ``jax.random`` draws.

The flags and defaults are the reference's, and ``--device`` (default
cuda) and ``--dist-backend``. ``--data-parallel N --model-parallel M``
spawn N * M rank processes (``launch/mesh.py::spawn_ranks``) on an
(N, M) (data, model) mesh that train one run (``launch/steps.py::
make_train_step(mesh=)``); rank 0 prints and writes ``--metrics-out``.
``--data-parallel 0`` means every device, which is one: the port's
launcher runs on one host process a rank. The backend is ``nccl`` on
cuda (a card a rank) and ``gloo`` on the cpu by default; ranks that
share one card need ``--dist-backend gloo``. Every assigned ``--arch``
trains; the pipeline gives
qwen2-vl its M-RoPE positions and patch embeddings and musicgen its
[B, S, K] codebook planes. ``--act-layers`` takes one approximant tag per
layer (``act_layers_of``).
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
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.optim import adamw, compress


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="olmo-1b",
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
                   help="per-layer approximant assignment: comma-separated "
                        "tags, one per layer (e.g. pwl-d16,cr-d32)")
    p.add_argument("--train-act", action="store_true",
                   help="unfreeze the approximant params (knots / "
                        "coefficients)")
    p.add_argument("--remat", default="none",
                   choices=["none", "block", "dots"])
    p.add_argument("--grad-compression", action="store_true")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="data axis size (0 = all devices: one)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model (tensor-parallel) axis size")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend of a sharded run (default "
                        "nccl on cuda, gloo on cpu; ranks sharing one card "
                        "need gloo)")
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


def mesh_shape(args) -> tuple:
    """(data, model) of the run: ``--data-parallel 0`` is one."""
    if args.data_parallel < 0 or args.model_parallel < 1:
        raise SystemExit("--data-parallel must be >= 0 and "
                         "--model-parallel >= 1")
    return max(args.data_parallel, 1), args.model_parallel


def main(argv=None):
    args = build_parser().parse_args(argv)
    shape = mesh_shape(args)
    world = shape[0] * shape[1]
    if world == 1:
        return train(args)
    backend = args.dist_backend or mesh_mod.default_backend(args.device)
    try:
        mesh_mod.check_backend(backend, args.device, world)
    except ValueError as e:
        raise SystemExit(f"--dist-backend {backend}: {e}")
    return mesh_mod.spawn_ranks(train_rank, world, backend=backend,
                                device=args.device, args=(args,))[0]


def train_rank(rank, world, device, args):
    """One rank of ``main --data-parallel N --model-parallel M``: the run
    on an (N, M) mesh over the initialised process group."""
    mesh = mesh_mod.make_host_mesh(*mesh_shape(args), device=device.type)
    return train(args, mesh=mesh, device=device, rank=rank)


def _materialize_local(cfg, seed, device, shardings):
    """The rank's blocks of the seed's weights: the ranks draw the whole
    tree on ``device`` in turn, each keeping its blocks and freeing the
    rest before the next starts."""
    import torch.distributed as dist
    local = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            full = M.materialize_params(cfg, seed=seed, device=device)
            local = M.shard_params(full, cfg, shardings)
            del full
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return local


def train(args, mesh=None, device=None, rank=0):
    """The run of ``args`` on one device, or this rank's part of it on
    ``mesh``; returns the summary (every rank the same)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    device = torch.device(device or args.device)
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
    if args.act_layers:
        from repro_torch.configs.common import act_layers_of
        cfg = act_layers_of(cfg, args.act_layers.split(","))
    mesh_tag = "" if mesh is None else (
        f" mesh={dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
        f"backend={torch.distributed.get_backend()}")
    say(f"[train] arch={cfg.name} act={cfg.activation.tag()} "
        f"device={device}{mesh_tag}")

    hyper = steps_mod.TrainHyper(
        opt=adamw.AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup,
                              decay_steps=max(args.steps, 2 * args.warmup)),
        remat=args.remat, grad_compression=args.grad_compression,
        train_act=args.train_act)
    step_fn = steps_mod.make_train_step(cfg, hyper, mesh=mesh)

    sharded = None
    if mesh is None:
        params = M.materialize_params(cfg, seed=args.seed, device=device)
    else:
        sharded = steps_mod.ShardedState(cfg, mesh, hyper=hyper)
        params = _materialize_local(cfg, args.seed, device,
                                    sharded.shardings)
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
                                       "activation": cfg.activation.tag()},
                             log=say, sharded=sharded)
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
    say("[train] done:", json.dumps(summary, indent=1))
    if args.metrics_out and rank == 0:
        Path(args.metrics_out).write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
