"""Int8 error-feedback gradient compression (counterpart of
``repro/optim/compress.py``).

Quantizes each gradient leaf to int8 with a per-leaf scale before the
optimizer sees it; the quantization residual is carried in an error
buffer and added back next step, so the compression bias telescopes away.
It models compressing the slow cross-slice all-reduce of a multislice
deployment. ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from .adamw import tree_leaves, tree_map, tree_unzip


def init_error(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _quantize_leaf(g, err, amax=None):
    """g + err -> (int8 payload dequantized, new error). ``amax``: the
    whole leaf's max |g + err| where the rank holds a block of it."""
    gf = g.to(torch.float32) + err
    if amax is None:
        amax = torch.max(torch.abs(gf))
    scale = amax / 127.0 + 1e-30
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq.to(g.dtype), gf - deq


def compress_grads(grads, error, reduce_max=None):
    """Returns (compressed grads, new error buffers). On sharded leaves
    ``reduce_max`` maps the per-leaf maxima of the rank's blocks (an f32
    vector in ``tree_leaves`` order) to the whole leaves' (an all_reduce
    MAX: ``parallel/dp.py::FSDP.reduce_max``), so each leaf has the one
    scale it has on one device."""
    if reduce_max is None:
        return tree_unzip(tree_map(_quantize_leaf, grads, error), 2)
    amax = reduce_max(torch.stack([
        torch.max(torch.abs(g.to(torch.float32) + e))
        for g, e in zip(tree_leaves(grads), tree_leaves(error))]))
    it = iter(amax.unbind())
    # tree_map visits a dict's keys in insertion order, tree_leaves in
    # sorted order: pair each leaf with its own max by position
    by_id = {id(g): a for g, a in zip(tree_leaves(grads), it)}
    return tree_unzip(tree_map(lambda g, e: _quantize_leaf(g, e,
                                                           by_id[id(g)]),
                               grads, error), 2)
