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

from .adamw import tree_map, tree_unzip


def init_error(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _quantize_leaf(g, err):
    """g + err -> (int8 payload dequantized, new error)."""
    gf = g.to(torch.float32) + err
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq.to(g.dtype), gf - deq


def compress_grads(grads, error):
    """Returns (compressed grads, new error buffers)."""
    return tree_unzip(tree_map(_quantize_leaf, grads, error), 2)
