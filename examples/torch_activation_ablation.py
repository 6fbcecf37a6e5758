"""The paper's deployment claim on the PyTorch/CUDA port, tested end to end:
training with the CR-spline activation unit is indistinguishable from
exact activations.

    PYTHONPATH=src python examples/torch_activation_ablation.py --steps 80
    PYTHONPATH=src python examples/torch_activation_ablation.py --per-layer
    PYTHONPATH=src python examples/torch_activation_ablation.py --device cpu

The twin of ``examples/activation_ablation.py``. Trains the SAME model
(same init, same data order) under four activation engines (exact float,
CR spline (the paper), bit-accurate Q2.13 CR (the paper's actual
circuit), and PWL (the paper's baseline)) and compares loss
trajectories; a deliberately coarse engine (taylor-2) shows what
degradation looks like. The engines run their plain routes (no kernel:
``use_kernel`` is off and no FFN is fused).

``--method`` widens the sweep across the Approximant registry: pass a
registered scheme (pwl | poly | rational | cr_spline) or ``all`` to
train under that scheme's engine too, and to print the per-scheme
error/gates table (Q2.13 qout datapath + NAND2 model) next to the CR
rows before training starts.

``--per-layer`` runs the gatecount-driven autotuner instead
(``repro_torch.core.autotune``): train once under the uniform CR depth-64
fixed baseline, search the scheme x depth x Q-format grid per layer, and
print the tuned assignment (layer -> scheme / depth / Q format / max err
/ gates) next to the uniform baselines it must beat.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import approximant as apx
from repro_torch.core import gatecount as gc
from repro_torch.core.activations import ActivationConfig, scheme_of
from repro_torch.core.error_analysis import tanh_error
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.optim import adamw


def train_once(cfg, steps: int, batch: int, seq: int, seed: int = 0,
               device="cuda"):
    params = M.materialize_params(cfg, seed=seed, device=device)
    opt = adamw.init_state(params)
    pipe = SyntheticPipeline(cfg, DataConfig(seed=seed + 1,
                                             vocab_size=cfg.vocab_size),
                             batch, seq, device=device)
    step = steps_mod.make_train_step(
        cfg, steps_mod.TrainHyper(remat="none", donate=True))
    losses = []
    for i in range(steps):
        params, opt, metrics = step(params, opt, pipe(i), i)
        losses.append(float(metrics["loss"]))
    return np.asarray(losses)


# representative geometry per scheme, straight from the registry
SCHEME_GEOM = {s: apx.get(s).default_geometry for s in apx.schemes()}


def scheme_table(schemes, device):
    """Per-scheme error/gates rows (Q2.13 qout; NAND2 model), with the
    paper's CR rows always present as the baseline."""
    print(f"\n{'scheme':>12} {'depth':>5} {'deg':>3} | {'RMS err':>9} "
          f"{'max err':>9} | {'gates':>6}")
    rows = [("cr_spline", dict(depth=32)), ("cr_spline", dict(depth=64))]
    rows += [(scheme_of(s) or s, SCHEME_GEOM.get(scheme_of(s) or s, {}))
             for s in schemes if scheme_of(s) != "cr_spline"]
    for scheme, geom in rows:
        depth, degree = geom.get("depth", 32), geom.get("degree", 3)
        err = tanh_error(scheme, depth, datapath="qout", degree=degree,
                         device=device)
        spec = apx.spec_for(scheme, "tanh", depth=depth, degree=degree)
        gates = round(gc.approximant_datapath(spec).gates)
        print(f"{scheme:>12} {depth:5d} {degree:3d} | {err.rms:9.6f} "
              f"{err.max:9.6f} | {gates:6d}")
    print()


def per_layer_table(args):
    """Autotune a per-layer assignment on a freshly trained smoke model
    and print it against the uniform baselines (the autotuner's contract:
    equal-or-better loss at strictly fewer summed gates)."""
    from repro_torch.core import autotune as at
    base = registry.get("olmo-1b", smoke=True)
    cfg = dataclasses.replace(base, activation=at.BASELINE_ACT)
    print(f"[per-layer] training {cfg.name} under uniform "
          f"{at.BASELINE_ACT.tag()} ({args.steps} steps)")
    params = at.train_smoke(cfg, steps=args.steps, batch=args.batch,
                            seq=args.seq, device=args.device)
    eval_fn = at.make_eval_fn(cfg, params, batch=args.batch, seq=args.seq,
                              device=args.device)
    candidates = at.candidate_grid(at.FULL_GRID, device=args.device)
    baseline = at.candidate_of(at.BASELINE_ACT, device=args.device)
    res = at.greedy_assign(eval_fn, cfg.n_layers, candidates, baseline,
                           log=print)

    uni32 = at.candidate_of(dataclasses.replace(at.BASELINE_ACT, depth=32),
                            device=args.device)
    print(f"\n{'layer':>5} {'tag':>22} {'scheme':>10} {'depth':>5} "
          f"{'qfmt':>6} | {'max err':>9} | {'gates':>6}")
    for i, c in enumerate(res.assignment):
        r = c.row()
        print(f"{i:5d} {r['tag']:>22} {r['scheme']:>10} {r['depth']:5d} "
              f"{r['qformat']:>6} | {r['max_err']:9.6f} | {r['gates']:6d}")
    n = cfg.n_layers
    for name, cand, loss in (
            ("uniform cr_fixed-d64", baseline, res.base_loss),
            ("uniform cr_fixed-d32", uni32,
             eval_fn((uni32.act,) * n)),
            ("autotuned", None, res.loss)):
        gates = res.gates if cand is None else cand.gates * n
        print(f"{name:>22}: loss {loss:.6f}  summed gates {gates:8.0f}")
    assert res.loss <= res.base_loss and res.gates < res.base_gates, \
        "autotuned assignment must match the uniform baseline's loss " \
        "at strictly fewer gates"
    print("[per-layer] autotuned assignment beats the uniform baseline; OK")
    return res


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=80)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--method", default=None,
                   help="also sweep a registered approximant scheme "
                        "(pwl|poly|rational|cr_spline) or 'all'")
    p.add_argument("--per-layer", action="store_true",
                   help="autotune a per-layer assignment and print it "
                        "against the uniform baselines")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if args.per_layer:
        return per_layer_table(args)

    base = registry.get("olmo-1b", smoke=True)
    engines = {
        "exact": ActivationConfig(impl="exact"),
        "cr (paper)": ActivationConfig(impl="cr", depth=32),
        "cr_fixed (Q2.13)": ActivationConfig(impl="cr_fixed", depth=32),
        "pwl-32": ActivationConfig(impl="pwl", depth=32),
        "taylor-2 (coarse)": ActivationConfig(impl="taylor", taylor_terms=2),
    }
    if args.method:
        schemes = (list(apx.schemes()) if args.method == "all"
                   else [args.method])
        scheme_table(schemes, dev)
        for s in schemes:
            s = scheme_of(s) or s
            if s in ("cr_spline", "pwl"):
                continue             # already in the base sweep (cr / pwl-32)
            geom = SCHEME_GEOM.get(s, {})
            engines[f"{s} (approximant)"] = ActivationConfig(
                impl=s, depth=geom.get("depth", 32),
                degree=geom.get("degree", 3))
    final = {}
    for name, act in engines.items():
        cfg = dataclasses.replace(base, activation=act)
        losses = train_once(cfg, args.steps, args.batch, args.seq,
                            device=dev)
        final[name] = losses
        print(f"{name:>18}: first {losses[0]:.4f}  "
              f"last8 {losses[-8:].mean():.4f}")

    ref = final["exact"][-8:].mean()
    gaps = {}
    for name in ("cr (paper)", "cr_fixed (Q2.13)"):
        gaps[name] = gap = abs(final[name][-8:].mean() - ref)
        print(f"[ablation] |{name} - exact| final-loss gap: {gap:.4f}")
        assert gap < 0.05, f"{name} diverged from exact training"
    print("[ablation] CR engines match exact training; OK")
    return dict(final={k: v.tolist() for k, v in final.items()}, gaps=gaps)


if __name__ == "__main__":
    main()
