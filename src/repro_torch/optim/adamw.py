"""AdamW + schedules + global-norm clipping, from scratch (counterpart of
``repro/optim/adamw.py``).

Parameter trees are nested dicts of tensors. The state mirrors the tree
(``m``, ``v`` shaped like the params) plus a 0-d int32 ``count``. The
arithmetic is f32, in the reference's order, and every scalar that
depends on the step (the schedule's learning rate, the bias corrections)
is a 0-d f32 tensor on the params' device, so it rounds as the
reference's ``jnp.float32`` does and nothing waits for the host.
Updates are functional: new tensors, the inputs untouched.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` shaped alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unzip(tree, n: int) -> tuple:
    """A tree whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = [tree_unzip(v, n) for v in tree.values()]
        return tuple(dict(zip(tree, (p[i] for p in parts)))
                     for i in range(n))
    return tuple(tree)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted-key order, the order in which
    ``jax.tree.leaves`` visits a dict (sums over leaves then add up in the
    reference's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def cosine_schedule(cfg: AdamWConfig, step, device=None):
    """Linear warmup to ``lr_peak``, then cosine decay to ``lr_min``. ``step``
    is a host int or a 0-d tensor; the result is a 0-d f32 tensor (on
    ``device`` for a host int)."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.full((), step, dtype=torch.float32, device=device)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> dict:
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree):
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def clip_by_global_norm(grads, max_norm: float):
    gnorm = global_norm(grads)
    # a true division, as the reference's (``max_norm / tensor`` in torch
    # multiplies by a rounded reciprocal)
    scale = torch.clamp(torch.full_like(gnorm, max_norm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def adamw_update(grads, state, params, cfg: AdamWConfig, lr):
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
        return p - lr * step_, m, v

    new_p, new_m, new_v = tree_unzip(
        tree_map(upd, grads, state["m"], state["v"], params), 3)
    return new_p, {"m": new_m, "v": new_v, "count": count}
