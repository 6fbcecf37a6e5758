"""A training cell: the program's train step (``repro_torch.launch.steps.
make_train_step`` with the job's defaults, as ``launch/train.py`` builds
it) over a ring of packed batches made in set-up.

Set-up makes the f32 masters from the seed, builds the step, and drives
it through the first ``check_steps`` steps (the window's own call and
feed, rows that all differ), reading what the check compares: each
step's loss, each leaf's first gradient as the optimizer took it (its
first moment after one step over 1 - b1) and each leaf's change after
the last of them. The window then runs the same step object on, and
ends at a device sync. After the window the program's state is freed and
the plain reference follows the same steps from the same seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchref import lm as ref

from . import roofline, traffic, weights


def _leaf_norms(tree, scale: float = 1.0, minus=None):
    out = {}
    for path, t in ref.leaves(tree):
        if path.split(".")[0] == "act":
            continue
        d = t.float() if minus is None else t.float() - ref._get(minus, path).float()
        out[path] = d.norm() * scale
    return out


def run(cell, args, rec, device, say, program=None):
    """Fills ``rec`` (a ``RunRecord``); ``program`` overrides the
    program's step builder (the tests' planted faults)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw

    from .spec import program_config
    s = cell.settings["train"]
    cfg = program_config(cell.config)
    model = cell.model
    B, S, R = s["batch"], s["seq"], s["ring"]
    n_check = s["check_steps"]
    tok, lab = traffic.train_ring(cell.traffic, B, S, R, model["vocab_size"],
                                  cell.config["eos_token_id"], args.seed)
    ring = [(torch.as_tensor(tok[i], device=device),
             torch.as_tensor(lab[i], device=device)) for i in range(R)]
    params = weights.make(cfg, model, args.seed, "train", device)
    hyper = steps_mod.TrainHyper()
    build = program or steps_mod.make_train_step
    step_fn = build(cfg, hyper)
    opt = adamw.init_state(params)
    start = params
    losses = []
    grad_norms = None
    skipped = torch.zeros((), dtype=torch.int32, device=device)
    for i in range(n_check):
        t, l_ = ring[i % R]
        params, opt, met = step_fn(params, opt, {"tokens": t, "labels": l_}, i)
        losses.append(met["loss"].detach().clone())
        skipped = skipped + met.get("skipped", 0)
        if i == 0:
            grad_norms = _leaf_norms(opt["m"], 1.0 / (1.0 - hyper.opt.b1))
    change_norms = _leaf_norms(params, minus=start)
    del start
    step_no = n_check
    readings = {"losses": [float(x) for x in losses],
                "grad_norms": {k: float(v) for k, v in grad_norms.items()},
                "change_norms": {k: float(v) for k, v in change_norms.items()}}
    _sync(device)
    rec.setup_s = time.perf_counter() - rec.t_process
    say(f"set-up {rec.setup_s:.3f} s; check steps' losses {readings['losses']}")

    # -- the window --------------------------------------------------------
    if device.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    n = 0
    t0 = time.perf_counter()
    while True:
        t, l_ = ring[step_no % R]
        params, opt, met = step_fn(params, opt, {"tokens": t, "labels": l_},
                                   step_no)
        skipped = skipped + met.get("skipped", 0)
        step_no += 1
        n += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    _sync(device)
    wall = time.perf_counter() - t0
    tokens = n * B * S
    rec.window = {"wall_s": wall, "steps": n, "tokens": tokens,
                  "model_flops": roofline.model_flops(model, tokens, "train")}
    if device.type == "cuda":
        rec.window["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        rec.peak_bytes = max(rec.peak_bytes, rec.window["peak_bytes"])
    rec.attempted, rec.failed = n + n_check, int(skipped)
    rec.metrics["train_tok_s"] = tokens / wall
    say(f"window: {n} steps in {wall:.3f} s, {tokens / wall:.1f} tokens/s")

    if args.trace:
        from . import trace
        state = {"params": params, "opt": opt, "step": step_no}

        def sliced(launches, k=cell.settings["trace"]["steps"]):
            with launches.in_range("bench.train_step"):
                for _ in range(k):
                    t_, l2 = ring[state["step"] % R]
                    state["params"], state["opt"], _ = step_fn(
                        state["params"], state["opt"],
                        {"tokens": t_, "labels": l2}, state["step"])
                    state["step"] += 1
            steps["bench.train_step"] = k

        steps: dict = {}
        rec.slice = trace.take(sliced, steps, say)
        params, opt = state["params"], state["opt"]

    # -- the check -----------------------------------------------------------
    del params, opt, met, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec.readings = readings
    rec.reference = reference_readings(cell, cfg, args.seed, device, "f32")


def reference_readings(cell, cfg, seed: int, device, precision: str):
    """The plain reference's losses, first gradient norms and change norms
    over the check steps, from the seed alone."""
    s = cell.settings["train"]
    model = cell.model
    ref.exact_f32()
    arch = ref.Arch.of(model)
    tok, lab = traffic.train_ring(cell.traffic, s["batch"], s["seq"],
                                  s["ring"], model["vocab_size"],
                                  cell.config["eos_token_id"], seed)
    batches = [(torch.as_tensor(tok[i % s["ring"]], device=device),
                torch.as_tensor(lab[i % s["ring"]], device=device))
               for i in range(s["check_steps"])]
    params = weights.make(cfg, model, seed, "train", device)
    return ref.train(params, batches, arch, ref.Precision(precision))


def compare(readings: dict, reference: dict) -> dict:
    """The numbers compared, each a gap relative to the reference:
    ``loss_gap`` the worst step's |loss - ref| / |ref|; ``grad_gap`` and
    ``change_gap`` the worst leaf's | |x| - |x_ref| | / max(|x_ref|, the
    median leaf's |x_ref|), over the leaves whose reference gradient is at
    least a thousandth of the median leaf's."""
    lg = max(abs(a - b) / abs(b) for a, b in zip(readings["losses"],
                                                 reference["losses"]))
    rg = reference["grad_norms"]
    med = float(np.median(list(rg.values())))
    keep = [k for k, v in rg.items() if v >= 1e-3 * med]

    def worst(got, want):
        m = float(np.median([want[k] for k in keep]))
        return max(abs(got[k] - want[k]) / max(want[k], m) for k in keep)

    return {"loss_gap": lg,
            "grad_gap": worst(readings["grad_norms"], rg),
            "change_gap": worst(readings["change_norms"],
                                reference["change_norms"]),
            "leaves_left_out": sorted(set(rg) - set(keep))}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
