"""AdamW + schedules + global-norm clipping, from scratch (counterpart of
``repro/optim/adamw.py``).

Parameter trees are nested dicts of tensors. The state mirrors the tree
(``m``, ``v`` shaped like the params) plus a 0-d int32 ``count``. The
arithmetic is f32, in the reference's order, and every scalar that
depends on the step (the schedule's learning rate, the bias corrections)
is a 0-d f32 tensor on the params' device, so it rounds as the
reference's ``jnp.float32`` does and nothing waits for the host.
Updates are functional: new tensors, the inputs untouched. The ``_``
variants (``clip_by_global_norm_``, ``adamw_update_``) do the same
arithmetic in place, for a caller that gives its trees up (one copy of
params and state on the device instead of two).
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


def _clip_scale(gnorm, max_norm: float):
    # a true division, as the reference's (``max_norm / tensor`` in torch
    # multiplies by a rounded reciprocal)
    return torch.clamp(torch.full_like(gnorm, max_norm)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float, norm=global_norm):
    """(grads scaled to a global norm of at most ``max_norm``, the norm).
    ``norm`` takes the norm of the tree (a sharded step's counts each
    element once over its mesh: ``parallel/dp.py::FSDP.global_norm``)."""
    gnorm = norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g * scale, grads), gnorm


def clip_by_global_norm_(grads, max_norm: float, norm=global_norm):
    """``clip_by_global_norm`` in place on ``grads``; returns gnorm."""
    gnorm = norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return gnorm


def _leaf_update(cfg: AdamWConfig, lr, count):
    """One leaf's AdamW step at the incremented ``count``: (g, m, v, p) ->
    (new p, new m, new v)."""
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

    return upd


def adamw_update(grads, state, params, cfg: AdamWConfig, lr):
    count = state["count"] + 1
    upd = _leaf_update(cfg, lr, count)
    new_p, new_m, new_v = tree_unzip(
        tree_map(upd, grads, state["m"], state["v"], params), 3)
    return new_p, {"m": new_m, "v": new_v, "count": count}


# elements of a leaf updated at once in place: the temporaries of one
# piece (a few f32 copies of it) stay ~1 GB however large the leaf (a
# layer-stacked projection of a 7B model is 1.6 G elements at 24 layers)
UPDATE_PIECE = 1 << 26


def _pieces(leaves):
    """The same leaves cut into pieces of at most UPDATE_PIECE elements
    (views: writes land in the leaves); whole where one is not
    contiguous."""
    if not all(t.is_contiguous() for t in leaves):
        return [leaves]
    return list(zip(*(t.view(-1).split(UPDATE_PIECE) for t in leaves)))


def adamw_update_(grads, state, params, cfg: AdamWConfig, lr, ok=None,
                  frozen=()):
    """``adamw_update`` in place: each leaf's new p, m and v come from the
    same arithmetic (element by element) and are written over the old
    ones, a piece of a leaf at a time, so the device holds one piece's new
    values beside the trees, not a second copy of them. With ``ok`` (a
    0-d bool tensor) every leaf and ``count`` keep their old values where
    it is false, chosen on the device. The top-level subtrees named in
    ``frozen`` are left as they are (the functional step restores them
    after the update)."""
    count = state["count"] + 1
    upd = _leaf_update(cfg, lr, count)
    keys = [k for k in params if k not in frozen]
    for leaves in zip(*(tree_leaves({k: t[k] for k in keys})
                        for t in (grads, state["m"], state["v"], params))):
        for g, m, v, p in _pieces(leaves):
            for old, new in zip((p, m, v), upd(g, m, v, p)):
                old.copy_(new if ok is None else torch.where(ok, new, old))
    state["count"].copy_(count if ok is None
                         else torch.where(ok, count, state["count"]))
