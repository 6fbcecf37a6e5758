"""Assigned input-shape cells and their input specs as meta tensors
(counterpart of ``repro/launch/shapes.py``, whose specs are
``ShapeDtypeStruct``s).

LM transformer shapes (seq_len x global_batch):
    train_4k     4096  x 256   -> train_step
    prefill_32k  32768 x 32    -> prefill_step
    decode_32k   32768 x 128   -> serve_step (1 token, cache of 32768)
    long_500k    524288 x 1    -> serve_step; sub-quadratic archs only

Pure full-attention archs skip long_500k (a 512k dense KV cache is the
quadratic regime this shape exists to exclude).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def is_subquadratic(cfg: ModelConfig) -> bool:
    """Archs whose decode state does not grow with full context:
    SSM (state only), hybrid (SWA ring + state), SWA (bounded ring)."""
    return cfg.use_mamba or cfg.parallel_mamba or cfg.sliding_window is not None


def applicable(cfg: ModelConfig, shape: ShapeCell) -> bool:
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return False
    return True


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras(cfg: ModelConfig, B: int, S: int) -> dict:
    """M-RoPE positions and patch embeddings, where the arch takes them."""
    out = {}
    if cfg.rope_kind == "mrope":
        out["mrope_positions"] = _meta((B, S, 3), torch.int32)
    if cfg.patch_embed_input:
        out["patch_embeds"] = _meta((B, S, cfg.d_model), dtype_of(cfg))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeCell):
    """Meta-tensor stand-ins for every model input of this cell (global
    shapes; no memory is allocated)."""
    B = shape.global_batch
    S = shape.seq_len
    K = cfg.n_codebooks

    def tok_shape(b, s):
        return (b, s, K) if K > 1 else (b, s)

    if shape.kind == "train":
        batch = {"tokens": _meta(tok_shape(B, S), torch.int32),
                 "labels": _meta(tok_shape(B, S), torch.int32)}
        batch.update(_extras(cfg, B, S))
        return {"batch": batch}

    if shape.kind == "prefill":
        batch = {"tokens": _meta(tok_shape(B, S), torch.int32)}
        batch.update(_extras(cfg, B, S))
        return {"batch": batch}

    # decode: one new token against a cache of S tokens
    batch = {"tokens": _meta(tok_shape(B, 1), torch.int32)}
    batch.update(_extras(cfg, B, 1))
    return {"batch": batch, "cache": M.cache_spec(cfg, B, S)}


def batch_axes(cfg: ModelConfig, shape: ShapeCell):
    """Logical axes tree for the batch dict (mirrors input_specs)."""
    K = cfg.n_codebooks
    tok = ("batch", "seq", None) if K > 1 else ("batch", "seq")
    axes = {"tokens": tok}
    if shape.kind == "train":
        axes["labels"] = tok
    if cfg.rope_kind == "mrope":
        axes["mrope_positions"] = ("batch", "seq", None)
    if cfg.patch_embed_input:
        axes["patch_embeds"] = ("batch", "seq", None)
    return axes
