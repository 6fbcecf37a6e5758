"""LM assembly: embeddings -> blocks -> norm -> head, plus the step
functions serving runs: full-sequence forward, ragged prefill, and
single-token decode against the per-slot KV cache (counterpart of
``repro/models/model.py``).

Layer parameters are stacked on a leading layer axis under
``params["blocks"]`` with the reference's key paths (so a reference
parameter tree carries over one to one, see ``params_from_numpy``); the
stack runners loop over layers in Python where the reference scans.

Cache contract (slot only in this slice): ``{"layers": {"k", "v":
[L, B, W, KV, hd]}, "cur": [B] or scalar, "k_pos": [B, W] or [W]}``.
Ring slot of absolute position p is p % W; k_pos = -1 marks an empty or
padded slot. Decode writes the new key and value into the cache in
place.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.activations import ActivationEngine, init_act_params

from .config import ModelConfig
from .layers import (BlockIO, apply_block, apply_norm, check_ported, dtype_of,
                     init_block, init_norm)

# leaves the reference casts to the compute dtype at every use
# (layers.py `.astype(cdt)`): attention / FFN matrices, biases, embedding
_COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv",
                             "w_gate", "w_up", "w_down", "embed"})


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig, device):
    """Random parameters with the reference's initializer scales and key
    paths (blocks stacked on a leading layer axis)."""
    check_ported(cfg)
    V, d = cfg.padded_vocab, cfg.d_model
    params: dict[str, Any] = {
        "embed": torch.randn((V, d), generator=gen, device=device) * 0.02,
        "ln_f": init_norm(cfg, device),
        "lm_head": torch.randn((d, V), generator=gen, device=device)
        * (1.0 / np.sqrt(d)),
    }
    layers = [init_block(gen, cfg, device) for _ in range(cfg.n_layers)]
    params["blocks"] = _stack_trees(layers)
    act = init_act_params(cfg.layer_activation_configs())
    if act:
        params["act"] = {tag: torch.as_tensor(arr, device=device)
                         for tag, arr in act.items()}
    return params


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def materialize_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random f32 parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (torch's generator: not the reference's
    ``jax.random`` values; carry those over with ``params_from_numpy``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_lm(gen, cfg, device)


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from jax
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The reference package's parameter tree (as numpy leaves, layer-
    stacked, e.g. ``jax.tree.map(np.asarray, params)``) -> this port's
    parameters. Both packages then compute the same function."""
    check_ported(cfg)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _to_tensor(t, device)

    out = conv(tree)
    missing = {"embed", "ln_f", "lm_head", "blocks"} - set(out)
    if missing:
        raise ValueError(f"parameter tree lacks {sorted(missing)}")
    if out["blocks"]["attn"]["wq"].shape[0] != cfg.n_layers:
        raise ValueError(f"tree has {out['blocks']['attn']['wq'].shape[0]} "
                         f"layers, {cfg.name} has {cfg.n_layers}")
    return out


def compute_params(params, cfg: ModelConfig):
    """Parameters with every leaf the reference casts to the compute dtype
    at each use cast ONCE, here. The values are the same (a cast is a
    pure function of the f32 master), so the numbers are the same; only
    the per-step casts are gone. Norm scales, the f32 lm_head and the
    approximant params stay as they are, as the reference uses them."""
    cdt = dtype_of(cfg)

    def conv(t, key=None):
        if isinstance(t, dict):
            return {k: conv(v, k) for k, v in t.items()}
        if key in _COMPUTE_LEAVES and t.is_floating_point():
            return t.to(cdt).contiguous()
        return t

    return conv(params)


def _layer(blocks, i: int):
    """Layer i's parameter subtree (views into the stacked tensors)."""
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    return blocks[i]


# ---------------------------------------------------------------------------
# embeddings & heads
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"].to(dtype_of(cfg))[tokens.long()]


def lm_logits(params, h, cfg: ModelConfig):
    """f32 head (a full f32 GEMM: TF32 stays off)."""
    return h.to(torch.float32) @ params["lm_head"].to(torch.float32)


# ---------------------------------------------------------------------------
# stack runners
# ---------------------------------------------------------------------------

def _bind_engine(engine, params):
    """Engine with tanh params bound from the model's ``params["act"]``."""
    act = params.get("act")
    return engine.bind(act) if act else engine


def _positions_for(cfg: ModelConfig, S: int, device, offset=0):
    return torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset


def run_stack_train(params, x, cfg: ModelConfig, engine: ActivationEngine):
    """Full-sequence stack (forward only in this slice)."""
    S = x.shape[1]
    ar = torch.arange(S, dtype=torch.int32, device=x.device)
    io = BlockIO(mode="train", positions=_positions_for(cfg, S, x.device),
                 q_pos=ar, k_pos=ar)
    for i in range(cfg.n_layers):
        x, _, _ = apply_block(_layer(params["blocks"], i), x, io, cfg, engine)
    return x, 0.0


def run_stack_prefill(params, x, cfg: ModelConfig, engine, capacity: int,
                      lengths=None):
    """Returns (x, stacked cache). With ``lengths`` (int [B]) the prefill
    is ragged: row b's prompt occupies positions [0, lengths[b]) of the
    right-padded block, the cache is per-slot and pad positions are
    excluded from it (k_pos = -1)."""
    S = x.shape[1]
    ar = torch.arange(S, dtype=torch.int32, device=x.device)
    io = BlockIO(mode="prefill", positions=_positions_for(cfg, S, x.device),
                 q_pos=ar, k_pos=ar)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, cache, _ = apply_block(_layer(params["blocks"], i), x, io, cfg,
                                  engine)
        for out, name in ((ks, "k"), (vs, "v")):
            kv = cache[name]
            out.append(_prefill_kv_to_cache(kv, capacity, S)
                       if lengths is None
                       else _prefill_kv_to_cache_ragged(kv, capacity, lengths))
    layers = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if lengths is None:
        return x, {"layers": layers,
                   "cur": torch.tensor(S, dtype=torch.int32, device=x.device),
                   "k_pos": _prefill_slot_positions(capacity, S, x.device)}
    return x, {"layers": layers, "cur": lengths.to(torch.int32),
               "k_pos": _prefill_slot_positions_ragged(capacity, lengths)}


def _prefill_kv_to_cache(kv, capacity: int, S: int):
    """[B,S,KV,hd] -> [B,W,KV,hd] ring-ordered cache of the last W tokens."""
    W = capacity
    if S < W:
        return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, W - S))
    last = kv[:, S - W:]                                   # positions S-W..S-1
    j = torch.arange(W, device=kv.device)
    i = (j - (S - W)) % W                                  # index into `last`
    return last[:, i]


def _ragged_ring_positions(capacity: int, lengths):
    """Absolute position held by each ring slot after a ragged prefill:
    (p [B,W], valid [B,W])."""
    W = capacity
    j = torch.arange(W, dtype=torch.int32, device=lengths.device)[None, :]
    start = torch.clamp(lengths - W, min=0).to(torch.int32)[:, None]
    p = start + torch.remainder(j - start, W)
    return p, p < lengths[:, None]


def _prefill_kv_to_cache_ragged(kv, capacity: int, lengths):
    """[B,S,KV,hd] + lengths [B] -> [B,W,KV,hd] per-row ring cache holding
    the last min(W, len_b) real tokens of each row (pads excluded)."""
    p, valid = _ragged_ring_positions(capacity, lengths)
    idx = torch.clamp(p, max=kv.shape[1] - 1).to(torch.int64)
    idx = idx[:, :, None, None].expand(-1, -1, kv.shape[2], kv.shape[3])
    out = torch.gather(kv, 1, idx)
    return torch.where(valid[:, :, None, None], out, torch.zeros((), dtype=out.dtype,
                                                                 device=out.device))


def _prefill_slot_positions(capacity: int, S: int, device):
    W = capacity
    j = torch.arange(W, dtype=torch.int32, device=device)
    if S < W:
        return torch.where(j < S, j, -1)
    return (S - W) + torch.remainder(j - (S - W), W)


def _prefill_slot_positions_ragged(capacity: int, lengths):
    p, valid = _ragged_ring_positions(capacity, lengths)
    return torch.where(valid, p, -1)


def run_stack_decode(params, x, cfg: ModelConfig, engine, cache):
    """One-token step. x: [B,1,d]. Returns (x, new_cache).

    ``cur`` is either a scalar (lockstep batch) or int [B] (per-slot);
    ``k_pos`` correspondingly [W] or [B, W]; the returned cache keeps the
    structure it was given. The layers' k/v are updated in place."""
    if "page_tbl" in cache:
        raise NotImplementedError("the paged cache is not ported yet "
                                  "(ROADMAP.md, Queue A item 8)")
    B = x.shape[0]
    cur = cache["cur"]
    per_slot = cur.dim() > 0
    cur_b = cur if per_slot else cur.expand(B)                     # [B]
    k_pos_vec = cache["k_pos"]
    W = k_pos_vec.shape[-1]
    slot = torch.remainder(cur_b, W).to(torch.int64)
    positions = cur_b[:, None].to(torch.int32)                     # [B, 1]
    kp = k_pos_vec if k_pos_vec.dim() == 2 else k_pos_vec[None, :].expand(B, W)
    upd = torch.arange(W, device=x.device)[None, :] == slot[:, None]
    k_pos_new = torch.where(upd, cur_b[:, None].to(kp.dtype), kp)  # [B, W]
    layers = cache["layers"]
    for i in range(cfg.n_layers):
        lcache = {"k": layers["k"][i], "v": layers["v"][i], "slot": slot}
        io = BlockIO(mode="decode", positions=positions, q_pos=cur_b,
                     k_pos=k_pos_new, cache=lcache)
        x, _, _ = apply_block(_layer(params["blocks"], i), x, io, cfg, engine)
    return x, {"layers": layers, "cur": cur + 1,
               "k_pos": k_pos_new if (per_slot or k_pos_vec.dim() == 2)
               else k_pos_new[0]}


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               per_slot: bool = False, device="cuda"):
    """Zero-filled cache (serving from scratch). Per-slot caches start
    fully invalid: cur = 0, every k_pos = -1 (masked)."""
    check_ported(cfg)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    W = cache_capacity(cfg, seq_len)
    cdt = dtype_of(cfg)
    layers = {name: torch.zeros((L, batch, W, KV, hd), dtype=cdt,
                                device=device) for name in ("k", "v")}
    if per_slot:
        return {"layers": layers,
                "cur": torch.zeros((batch,), dtype=torch.int32, device=device),
                "k_pos": torch.full((batch, W), -1, dtype=torch.int32,
                                    device=device)}
    return {"layers": layers,
            "cur": torch.zeros((), dtype=torch.int32, device=device),
            "k_pos": torch.full((W,), -1, dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def forward_fn(params, batch, cfg: ModelConfig, engine: ActivationEngine):
    """Full-sequence logits, no cache (tests / evaluation)."""
    engine = _bind_engine(engine, params)
    x = embed_tokens(params, batch["tokens"], cfg)
    x, _ = run_stack_train(params, x, cfg, engine)
    x = apply_norm(params["ln_f"], x, cfg)
    return lm_logits(params, x, cfg)


def prefill_fn(params, batch, cfg: ModelConfig, engine: ActivationEngine,
               capacity: int | None = None, lengths=None):
    """With ``lengths`` (int [B], or a batch["lengths"] entry) the prompt
    block is ragged/right-padded: logits are read at each row's last real
    token and the cache is per-slot."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    capacity = capacity or cache_capacity(cfg, S)
    if lengths is None:
        lengths = batch.get("lengths")
    engine = _bind_engine(engine, params)
    x = embed_tokens(params, tokens, cfg)
    x, cache = run_stack_prefill(params, x, cfg, engine, capacity,
                                 lengths=lengths)
    x = apply_norm(params["ln_f"], x, cfg)
    if lengths is None:
        last = x[:, -1:]
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        last = x[rows, (lengths - 1).to(torch.int64)][:, None]   # [B, 1, d]
    logits = lm_logits(params, last, cfg)[:, 0]
    return logits, cache


def decode_fn(params, batch, cache, cfg: ModelConfig, engine: ActivationEngine):
    engine = _bind_engine(engine, params)
    x = embed_tokens(params, batch["tokens"], cfg)         # [B, 1, d]
    x, cache = run_stack_decode(params, x, cfg, engine, cache)
    x = apply_norm(params["ln_f"], x, cfg)
    return lm_logits(params, x, cfg)[:, 0], cache
