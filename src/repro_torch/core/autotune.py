"""Gatecount-driven per-layer approximant autotuner (counterpart of
``repro/core/autotune.py``).

Given a trained model, assign each layer its own activation approximant
(scheme x LUT depth x Q format) so the SUMMED NAND2-equivalent gate
count of the per-layer tanh units is minimized subject to a task-loss
budget measured on the real model: the hardware-software co-design
loop the per-layer assignment machinery (ModelConfig.act_layers,
core/activations.py::LayerEngines) exists to serve.

The search is coordinate-descent greedy: starting from the uniform
baseline (the paper's CR spline at depth 64, Q2.13, on its bit-accurate
integer datapath), each layer in turn tries the candidate grid in
ascending gate order and keeps the CHEAPEST candidate whose
full-assignment eval loss stays within the budget; passes repeat until
a whole sweep accepts nothing. Every candidate is evaluated on its
``<scheme>_fixed`` integer datapath, so the loss the tuner optimizes is
the loss the synthesized unit would produce, not a float stand-in.
Losses are deterministic (fixed eval batches, frozen params), so the
accept/reject trace is reproducible.

Cost model: one tanh unit per layer (``core/gatecount.py::
approximant_datapath`` at the candidate's own spec), so the objective
is the sum over layers of per-unit gates. The candidates' error
analysis and the model harness run on ``device``: the card unless the
caller passes ``device="cpu"`` (without a card the default raises).
"""
from __future__ import annotations

import dataclasses

from . import gatecount as gc
from .activations import ActivationConfig, fixed_scheme_of, tanh_spec_of
from .error_analysis import tanh_error
from .fixed_point import QFormat


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the assignment grid: an activation config plus its
    precomputed hardware cost and fixed-datapath accuracy."""
    act: ActivationConfig
    gates: float
    max_err: float

    @property
    def tag(self) -> str:
        return self.act.tag()

    def row(self) -> dict:
        spec = tanh_spec_of(self.act)
        return dict(tag=self.tag, scheme=spec.scheme, depth=spec.depth,
                    degree=spec.degree, qformat=str(spec.qformat),
                    gates=round(self.gates), max_err=self.max_err)


def candidate_of(act: ActivationConfig, device="cuda") -> Candidate:
    """Score one activation config: NAND2 gates from the analytic area
    model and max error of its bit-accurate fixed datapath over the
    full Q-format input lattice (run on ``device``)."""
    spec = tanh_spec_of(act)
    if spec is None or fixed_scheme_of(act.impl) is None:
        raise ValueError(f"autotuner candidates must be '<scheme>_fixed' "
                         f"integer datapaths, got impl={act.impl!r}")
    err = tanh_error(spec.scheme, act.depth, datapath="fixed",
                     fmt=QFormat(act.int_bits, act.frac_bits),
                     degree=act.degree, device=device)
    return Candidate(act=act, gates=gc.approximant_datapath(spec).gates,
                     max_err=err.max)


def _fixed_impl(scheme: str) -> str:
    return "cr_fixed" if scheme == "cr_spline" else f"{scheme}_fixed"


# The paper's flagship unit: CR spline, depth 64, Q2.13: the uniform
# assignment every tuned one must beat on summed gates without losing
# task loss.
BASELINE_ACT = ActivationConfig(impl="cr_fixed", depth=64)

# scheme x depth x Q-format grid. frac_bits sweeps below the flagship
# 13 too: a layer that tolerates Q2.10 buys a much smaller multiplier.
FULL_GRID = (
    [("cr_spline", dict(depth=d)) for d in (16, 32, 64)]
    + [("pwl", dict(depth=d)) for d in (32, 64)]
    + [("poly", dict(depth=d, degree=3)) for d in (8, 16)]
    + [("rational", dict(degree=5))]
    + [("cr_spline", dict(depth=32, frac_bits=10)),
       ("pwl", dict(depth=64, frac_bits=10)),
       ("pwl", dict(depth=64, frac_bits=16))]
)

# smoke grid: one cheap point per scheme + one narrow-format point.
REDUCED_GRID = (
    [("cr_spline", dict(depth=32)), ("pwl", dict(depth=64)),
     ("poly", dict(depth=16, degree=3)), ("rational", dict(degree=5)),
     ("pwl", dict(depth=64, frac_bits=10))]
)


def candidate_grid(grid=FULL_GRID, x_max: float = 4.0,
                   device="cuda") -> list[Candidate]:
    """Scored candidates for a (scheme, geometry) grid, every one on its
    integer datapath."""
    out = []
    for scheme, geom in grid:
        act = ActivationConfig(
            impl=_fixed_impl(scheme), x_max=x_max,
            depth=geom.get("depth", 32), degree=geom.get("degree", 3),
            int_bits=geom.get("int_bits", 2),
            frac_bits=geom.get("frac_bits", 13))
        out.append(candidate_of(act, device=device))
    return out


@dataclasses.dataclass
class AutotuneResult:
    baseline: Candidate
    assignment: list[Candidate]        # one per layer
    base_loss: float
    loss: float                        # eval loss of the final assignment
    evals: int                         # distinct assignments evaluated
    history: list[dict]                # accepted swaps, in order

    @property
    def base_gates(self) -> float:
        return self.baseline.gates * len(self.assignment)

    @property
    def gates(self) -> float:
        return sum(c.gates for c in self.assignment)


def greedy_assign(eval_fn, n_layers: int, candidates: list[Candidate],
                  baseline: Candidate, *, budget_slack: float = 0.0,
                  max_rounds: int = 3, log=None) -> AutotuneResult:
    """Coordinate-descent greedy search. ``eval_fn(layer_cfgs)`` maps a
    per-layer ActivationConfig tuple to the model's eval loss (cached
    here: the search revisits assignments). A swap is accepted iff the
    candidate is strictly cheaper than the layer's current unit AND the
    full-assignment loss stays within ``base_loss * (1+budget_slack)``;
    rounds repeat until a sweep accepts nothing (or ``max_rounds``)."""
    say = log or (lambda *_: None)
    cache: dict[tuple, float] = {}

    def loss_of(assign):
        key = tuple(c.tag for c in assign)
        if key not in cache:
            cache[key] = float(eval_fn(tuple(c.act for c in assign)))
        return cache[key]

    assign = [baseline] * n_layers
    base_loss = loss_of(assign)
    budget = base_loss * (1.0 + budget_slack)
    say(f"baseline {baseline.tag}: loss {base_loss:.6f}, "
        f"{round(baseline.gates)} gates/layer, budget {budget:.6f}")
    ordered = sorted(candidates, key=lambda c: c.gates)
    history: list[dict] = []
    loss = base_loss
    for rnd in range(max_rounds):
        changed = False
        for i in range(n_layers):
            for cand in ordered:
                if cand.gates >= assign[i].gates:
                    break              # ascending order: nothing cheaper left
                trial = list(assign)
                trial[i] = cand
                trial_loss = loss_of(trial)
                if trial_loss <= budget:
                    say(f"  layer {i}: {assign[i].tag} -> {cand.tag} "
                        f"({round(assign[i].gates)} -> {round(cand.gates)} "
                        f"gates, loss {trial_loss:.6f})")
                    history.append(dict(round=rnd, layer=i,
                                        tag=cand.tag, loss=trial_loss))
                    assign, loss, changed = trial, trial_loss, True
                    break
        if not changed:
            break
    return AutotuneResult(baseline=baseline, assignment=assign,
                          base_loss=base_loss, loss=loss,
                          evals=len(cache), history=history)


# --------------------------------------------------------------------------
# model-in-the-loop harness (lazy imports: core must stay importable
# without the model/launch stack)
# --------------------------------------------------------------------------

def train_smoke(cfg, steps: int, batch: int, seq: int, seed: int = 0,
                device="cuda"):
    """Train ``cfg`` from scratch on the synthetic pipeline on ``device``
    and return the final params: the frozen weights every assignment is
    scored against. Params and optimizer state are updated in place
    (``TrainHyper(donate=True)``)."""
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    params = M.materialize_params(cfg, seed=seed, device=device)
    opt = adamw.init_state(params)
    pipe = SyntheticPipeline(
        cfg, DataConfig(seed=seed + 1, vocab_size=cfg.vocab_size),
        batch, seq, device=device)
    step = steps_mod.make_train_step(
        cfg, steps_mod.TrainHyper(remat="none", donate=True))
    for i in range(steps):
        params, opt, _ = step(params, opt, pipe(i), i)
    return params


def eval_fn_of(cfg, params, batches):
    """The task-loss oracle of ``make_eval_fn`` over given batches
    ({"tokens", "labels"} on the params' device): the mean loss of the
    frozen params under a per-layer activation assignment, one engine
    build per call, no autograd graph kept."""
    import numpy as np
    import torch

    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model as M

    def eval_fn(layer_cfgs) -> float:
        cfg2 = dataclasses.replace(cfg, act_impl="",
                                   act_layers=tuple(layer_cfgs))
        engine = steps_mod._make_engine(cfg2)
        with torch.no_grad():
            return float(np.mean([
                float(M.loss_fn(params, b, cfg2, engine, remat="none")[0])
                for b in batches]))

    return eval_fn


def make_eval_fn(cfg, params, *, batch: int, seq: int,
                 eval_batches: int = 2, seed: int = 1234, device="cuda"):
    """Deterministic task-loss oracle: mean loss of the frozen params
    over fixed held-out synthetic batches (made on ``device``), under
    ANY per-layer activation assignment."""
    from repro_torch.data import DataConfig, SyntheticPipeline
    pipe = SyntheticPipeline(
        cfg, DataConfig(seed=seed, vocab_size=cfg.vocab_size), batch, seq,
        device=device)
    return eval_fn_of(cfg, params, [pipe(i) for i in range(eval_batches)])
