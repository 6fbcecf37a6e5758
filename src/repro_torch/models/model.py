"""LM assembly: embeddings -> blocks -> norm -> head, plus the step
functions: the train loss, full-sequence forward, ragged prefill, and
single-token decode against the per-slot KV cache (counterpart of
``repro/models/model.py``).

Layer parameters are stacked on a leading layer axis under
``params["blocks"]`` with the reference's key paths (so a reference
parameter tree carries over one to one, see ``params_from_numpy``); the
stack runners loop over layers in Python where the reference scans, and
run layer i under its own engine (``engine_of_layer``: a per-layer
``LayerEngines`` assignment, or one engine for every layer).

Slot cache contract: ``{"layers": {"k", "v": [L, B, W, KV, hd]}, "cur":
[B] or scalar, "k_pos": [B, W] or [W]}``. Ring slot of absolute position
p is p % W; k_pos = -1 marks an empty or padded slot. A Mamba stack adds
``layers.conv`` [L, B, ck-1, di] (compute dtype) and ``layers.ssm``
[L, B, di, N] (f32); a pure-SSM stack (falcon-mamba) has no k/v and no
``k_pos``.

Paged cache contract (the serve engine's default): ``layers.k/v`` are
one shared page pool [L, P, page_size, KV, hd] and ``page_tbl`` [B, n]
maps each slot's logical ring pages to pool pages; ``k_pos`` is
[B, n * page_size]. Logical ring slot j of row b lives at page
``page_tbl[b, j // page_size]``, offset ``j % page_size``. Physical page
0 is the trash page: dead and unallocated logical pages map there. The
hybrid block's ``conv`` / ``ssm`` stay per slot beside the pool.

Decode, chunked prefill and the engine's inserts write the cache in
place.

Tensor parallelism: ``abstract_params`` gives the parameters' shapes (on
the meta device) and logical axes, ``cache_spec`` / ``paged_cache_spec``
and their ``*_axes`` the caches'; ``launch/steps.py::serve_shardings``
resolves them on a mesh and ``shard_params`` cuts a rank's blocks. The
embedding is then vocab-parallel (each rank looks up its rows, the group
sums) and the head's logits are gathered whole on every rank. Sharded
training (``launch/steps.py::make_train_step(mesh=)``) cuts the params
over ``data`` too (``train_shardings``): ``loss_fn(fsdp=)`` gathers them
whole over ``data`` at use (``parallel/dp.py``), a layer at a time, and
returns the global loss.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core.activations import (ActivationEngine, engine_of_layer,
                                          init_act_params)
from repro_torch.optim.adamw import tree_map
from repro_torch.parallel import dp, tp

from .config import ModelConfig
from .layers import (BlockIO, apply_block, apply_norm, block_axes, dtype_of,
                     init_block, init_norm, norm_axes)

# leaves the reference casts to the compute dtype at every use
# (layers.py `.astype(cdt)`): attention / FFN matrices (the MoE expert
# stacks and shared expert too), biases, embedding, and Mamba's
# projections and conv. Not the MoE router (it routes in f32), nor
# Mamba's A_log, D and dt_proj_b (used in f32).
_COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv",
                             "w_gate", "w_up", "w_down", "embed",
                             "in_proj", "conv_w", "conv_b", "x_proj",
                             "dt_proj_w", "out_proj"})


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig, device):
    """Random parameters with the reference's initializer scales and key
    paths (blocks stacked on a leading layer axis). A multi-codebook
    model (K = n_codebooks > 1) has one embedding and one head per
    codebook: [K, V, d] and [K, d, V]."""
    V, d, K = cfg.padded_vocab, cfg.d_model, cfg.n_codebooks
    lead = (K,) if K > 1 else ()
    params: dict[str, Any] = {
        "embed": torch.randn(lead + (V, d), generator=gen, device=device)
        * 0.02,
        "ln_f": init_norm(cfg, device),
        "lm_head": torch.randn(lead + (d, V), generator=gen, device=device)
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

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _to_tensor(t, device)

    out = conv(tree)
    missing = {"embed", "ln_f", "lm_head", "blocks"} - set(out)
    if missing:
        raise ValueError(f"parameter tree lacks {sorted(missing)}")
    n = _first_leaf(out["blocks"]).shape[0]      # every leaf is layer-stacked
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    return out


def param_axes(cfg: ModelConfig):
    """The logical axes tree of ``init_lm``'s parameters (the reference's
    boxes): blocks carry a leading "layer" axis, the act leaves none."""
    K = cfg.n_codebooks
    embed = ("codebook", "vocab", "embed") if K > 1 else ("vocab", "embed")
    axes: dict[str, Any] = {
        "embed": embed,
        "ln_f": norm_axes(cfg),
        "lm_head": ("codebook", "embed", "vocab") if K > 1 else
        ("embed", "vocab"),
        "blocks": tree_map(lambda a: ("layer",) + a, block_axes(cfg)),
    }
    act = init_act_params(cfg.layer_activation_configs())
    if act:
        axes["act"] = {tag: (None,) * np.ndim(arr) for tag, arr in
                       act.items()}
    return axes


@functools.lru_cache(maxsize=64)
def _param_shapes(cfg: ModelConfig):
    """(shape, dtype) of every parameter leaf of ``cfg`` (one init on the
    meta device a config: its random draws take a while even there)."""
    return tree_map(lambda t: (tuple(t.shape), t.dtype),
                    init_lm(None, cfg, torch.device("meta")))


def abstract_params(cfg: ModelConfig, seed: int = 0):
    """(shapes_tree, axes_tree) without allocating anything: the shapes
    are f32 tensors on the meta device (``seed`` draws nothing there)."""
    return (tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1],
                                            device="meta"),
                     _param_shapes(cfg)), param_axes(cfg))


def shard_params(params, cfg: ModelConfig, shardings):
    """A full parameter tree (e.g. from ``params_from_numpy`` or
    ``materialize_params``, or AdamW's ``m`` / ``v`` of it) -> this
    rank's blocks of it, by ``shardings`` (``launch/steps.py::
    serve_shardings``' first tree, or ``train_shardings``', which also
    cut dims over ``data``).
    Mamba's ``in_proj`` [d, 2 * di] holds the ``x | z`` halves side by
    side; each half is cut on its own, so a rank holds the same channels
    of both. Sharded leaves are copied; whole ones are kept as they are,
    and so is a leaf that already has its block's shape (a tree this
    function returned), so sharding twice changes nothing."""

    def cut(t, full, sh, key):
        t = torch.as_tensor(t)
        if tuple(t.shape) != tuple(full.shape):
            if tuple(t.shape) == sh.local_shape(full.shape):
                return t
            raise ValueError(f"{key}: shape {tuple(t.shape)} is neither "
                             f"{cfg.name}'s {tuple(full.shape)} nor a "
                             "rank's block of it")
        if key == "in_proj" and any(sh.spec):
            x, z = t.chunk(2, dim=-1)
            return torch.cat([sh.shard(x), sh.shard(z)], dim=-1)
        return sh.shard(t).contiguous()

    def walk(t, full, sh, key=None):
        if isinstance(t, dict):
            return {k: walk(v, full[k], sh[k], k) for k, v in t.items()}
        return cut(t, full, sh, key)

    return walk(params, abstract_params(cfg)[0], shardings)


def _first_leaf(tree):
    """The first tensor of a nested dict (None when it holds none: a
    non-parametric norm's ``{}``)."""
    if not isinstance(tree, dict):
        return tree
    for v in tree.values():
        leaf = _first_leaf(v)
        if leaf is not None:
            return leaf
    return None


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


def _layers(blocks, n: int) -> list:
    """Every layer's parameter subtree at once (``torch.unbind`` of each
    stacked tensor). Differentiating n ``_layer`` views builds n
    full-size zero gradients of every stacked tensor and adds them up;
    ``unbind`` stacks the n slice gradients once."""
    if isinstance(blocks, dict):
        per_key = {k: _layers(v, n) for k, v in blocks.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(blocks))


# ---------------------------------------------------------------------------
# embeddings & heads
# ---------------------------------------------------------------------------

class _EmbedRows(torch.autograd.Function):
    """``table[ids]`` whose backward adds each row's gradient into a zero
    table with ``index_add_``: the indexed scatter ``table[ids]``
    differentiates to sorts the ids and makes the host wait for the
    device, once a train step. On the card the adds are atomic, so the
    gradients of a repeated id sum in no fixed order; on the CPU in order."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = tuple(table.shape)
        return table.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        grad.index_add_(0, ids.reshape(-1),
                        g.reshape((-1,) + ctx.table_shape[1:]))
        return grad, None


def embed_tokens(params, tokens, cfg: ModelConfig, patch_embeds=None):
    """Token embeddings in the compute dtype: tokens [B, S], or [B, S, K]
    for K codebooks (the K planes' embeddings summed, plane 0 first); a
    patch-embedding arch adds ``patch_embeds`` [B, S, d] when given."""
    cdt = dtype_of(cfg)
    emb = params["embed"].to(cdt)
    tokens = tokens.long()
    K = cfg.n_codebooks
    if emb.shape[-2] != cfg.padded_vocab:
        # vocab-parallel: each plane's rows of this rank's id range, the
        # group's exact f32 sum, then the planes added as below
        tables = [emb[k] for k in range(K)] if K > 1 else [emb]
        ids = [tokens[..., k] for k in range(K)] if K > 1 else [tokens]
        rows = torch.stack([tp.vocab_rows(_EmbedRows.apply, t, i)
                            for t, i in zip(tables, ids)])
        planes = list(tp.vocab_sum(rows).to(cdt))
        x = sum(planes) if K > 1 else planes[0]
    elif K > 1:
        x = sum(_EmbedRows.apply(emb[k], tokens[..., k])
                for k in range(cfg.n_codebooks))
    else:
        x = _EmbedRows.apply(emb, tokens)
    if cfg.patch_embed_input and patch_embeds is not None:
        x = x + patch_embeds.to(cdt)
    return x


def lm_logits(params, h, cfg: ModelConfig):
    """f32 head (a full f32 GEMM: TF32 stays off); K codebooks give
    [B, S, K, V]."""
    head = params["lm_head"].to(torch.float32)
    hf = h.to(torch.float32)
    if head.shape[-1] != cfg.padded_vocab:     # column-parallel over vocab
        hf = tp.enter(hf)
    if cfg.n_codebooks > 1:
        logits = torch.einsum("bsd,kdv->bskv", hf, head)
    else:
        logits = hf @ head
    if head.shape[-1] != cfg.padded_vocab:
        logits = tp.gather_last(logits, cfg.padded_vocab)
    return logits


# ---------------------------------------------------------------------------
# stack runners
# ---------------------------------------------------------------------------

def _bind_engine(engine, params):
    """Engine(s) with tanh params bound from the model's ``params["act"]``
    (a ``LayerEngines`` binds each distinct engine to its own leaf)."""
    act = params.get("act")
    return engine.bind(act) if act else engine


def _positions_for(cfg: ModelConfig, S: int, device, offset=0, batch=None):
    """RoPE positions [1, S] from ``offset``; under M-RoPE the batch's
    ``mrope_positions`` [B, S, 3] when it has them, else the text
    positions on all three sections."""
    if cfg.rope_kind == "mrope" and batch and "mrope_positions" in batch:
        return batch["mrope_positions"]
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset
    if cfg.rope_kind == "mrope":
        return pos[..., None].expand(pos.shape + (3,))
    return pos


# aten matmuls whose outputs remat="dots" keeps (the counterpart of
# jax.checkpoint_policies.checkpoint_dots); everything else is recomputed
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(block_fn, remat: str):
    """``block_fn`` under the remat policy: "none" keeps every activation,
    "block" keeps only the block's input and reruns its forward in the
    backward, "dots" keeps the matmul outputs and reruns the rest. A rerun
    forward launches the block's kernels again."""
    if remat == "none":
        return block_fn
    from torch.utils import checkpoint as ckpt
    if remat == "block":
        return lambda *a: ckpt.checkpoint(block_fn, *a, use_reentrant=False)
    if remat == "dots":
        ctx_fn = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                   _dots_policy)
        return lambda *a: ckpt.checkpoint(block_fn, *a, use_reentrant=False,
                                          context_fn=ctx_fn)
    raise ValueError(f"unknown remat {remat!r} (none | block | dots)")


def run_stack_train(params, x, cfg: ModelConfig, engine, remat: str = "block",
                    batch=None, fsdp=None):
    """Full-sequence stack under a remat policy (``_remat_block``). Returns
    (x, the MoE aux loss summed over layers and divided by n_layers: a 0-d
    f32 zero for dense blocks). ``batch`` may carry ``mrope_positions``.
    With ``fsdp`` (``parallel/dp.py::FSDP``) each layer's parameters are
    gathered whole over ``data`` inside its remat region."""
    S = x.shape[1]
    ar = torch.arange(S, dtype=torch.int32, device=x.device)
    io = BlockIO(mode="train",
                 positions=_positions_for(cfg, S, x.device, batch=batch),
                 q_pos=ar, k_pos=ar)

    def block_fn(x, layer_params, eng):
        if fsdp is not None:
            layer_params = fsdp.gather_layer(layer_params)
        y, _, aux = apply_block(layer_params, x, io, cfg, eng)
        return y, aux

    block_fn = _remat_block(block_fn, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer_params in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x, aux_i = block_fn(x, layer_params, engine_of_layer(engine, i))
        if torch.is_tensor(aux_i):
            aux = aux + aux_i
    return x, aux / cfg.n_layers


def _has_kv(cfg: ModelConfig) -> bool:
    """Whether the stack keeps a KV ring (and with it ``k_pos``)."""
    return cfg.has_attention or cfg.parallel_mamba


def run_stack_prefill(params, x, cfg: ModelConfig, engine, capacity: int,
                      lengths=None, batch=None):
    """Returns (x, stacked cache). With ``lengths`` (int [B]) the prefill
    is ragged: row b's prompt occupies positions [0, lengths[b]) of the
    right-padded block, the cache is per-slot and pad positions are
    excluded from it (k_pos = -1). Pad tokens never reach a real row's
    k/v, but they do run through its Mamba state: a stateful arch
    prefills ragged only at lengths == S (the engine's exact buckets)."""
    S = x.shape[1]
    ar = torch.arange(S, dtype=torch.int32, device=x.device)
    io = BlockIO(mode="prefill",
                 positions=_positions_for(cfg, S, x.device, batch=batch),
                 q_pos=ar, k_pos=ar)
    caches: dict[str, list] = {}
    for i in range(cfg.n_layers):
        x, cache, _ = apply_block(_layer(params["blocks"], i), x, io, cfg,
                                  engine_of_layer(engine, i))
        for name, val in cache.items():
            if name in ("k", "v"):
                val = (_prefill_kv_to_cache(val, capacity, S)
                       if lengths is None
                       else _prefill_kv_to_cache_ragged(val, capacity,
                                                        lengths))
            caches.setdefault(name, []).append(val)
    out = {"layers": {name: torch.stack(v) for name, v in caches.items()}}
    if lengths is None:
        out["cur"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        if _has_kv(cfg):
            out["k_pos"] = _prefill_slot_positions(capacity, S, x.device)
    else:
        out["cur"] = lengths.to(torch.int32)
        if _has_kv(cfg):
            out["k_pos"] = _prefill_slot_positions_ragged(capacity, lengths)
    return x, out


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


def run_stack_prefill_prefix(params, x, cfg: ModelConfig, engine,
                             prefix_kv, prefix_len: int, capacity: int,
                             page_size: int, lengths, batch=None):
    """Ragged prefill of prompt *suffixes* against an already-cached,
    page-aligned shared prefix (prefix caching).

    ``x`` embeds the suffix tokens (right-padded to S); ``prefix_kv`` is
    the per-layer prefix k/v gathered from the page pool ({"k"/"v"}:
    [L, prefix_len, KV, hd], shared by every row). Each layer attends
    suffix queries over [prefix ++ suffix] keys — causal masking hides
    the row's pad keys exactly as in the cold ragged path — and returns
    the suffix k/v padded to whole pages, in sequence order (suffix page
    j holds positions prefix_len + [j*ps, (j+1)*ps)). Requires no
    sliding window, so ring order is sequence order and the returned
    ``cur``/``k_pos`` cover positions [0, prefix_len + len_b)."""
    S = x.shape[1]
    dev = x.device
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    io = BlockIO(mode="prefill",
                 positions=_positions_for(cfg, S, dev, offset=prefix_len,
                                          batch=batch),
                 q_pos=prefix_len + ar,
                 k_pos=torch.arange(prefix_len + S, dtype=torch.int32,
                                    device=dev))
    pad = (-S) % page_size
    ks, vs = [], []
    for i in range(cfg.n_layers):
        io.cache = {"k_pre": prefix_kv["k"][i], "v_pre": prefix_kv["v"][i]}
        x, cache, _ = apply_block(_layer(params["blocks"], i), x, io, cfg,
                                  engine_of_layer(engine, i))
        for out, name in ((ks, "k"), (vs, "v")):
            kv = cache[name]
            out.append(torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
                       if pad else kv)
    total = prefix_len + lengths.to(torch.int32)                 # [B]
    j = torch.arange(capacity, dtype=torch.int32, device=dev)[None, :]
    k_pos = torch.where(j < total[:, None], j, -1)
    return x, {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)},
               "cur": total, "k_pos": k_pos}


def run_stack_prefill_chunk(params, x, cfg: ModelConfig, engine, pool_kv,
                            tbl_row, k_pos_row, pos: int, clen: int,
                            page_size: int, batch=None):
    """Resume a ragged prefill at prompt offset ``pos`` for ONE paged slot
    (chunked admission: serve/engine.py interleaves these chunks with
    decode chunks under a token budget).

    ``x`` embeds the chunk's tokens right-padded to S; the chunk covers
    absolute positions [pos, pos + clen) (host ints). ``pool_kv`` is the
    shared page pool ({"k"/"v"}: [L, P, ps, KV, hd]), written in place;
    ``tbl_row`` [n] the slot's page table and ``k_pos_row`` [n*ps] its
    current ring validity row (the caller resets it on the first chunk;
    a prefix-cache hit starts with the shared pages' positions marked).

    Each layer gathers the slot's FULL padded ring through its page table
    as k_pre/v_pre, before this chunk's writes, and the flash mask
    (causal + sliding window + k_pos >= 0) decides what is visible, so no
    page alignment is imposed on the chunk and sliding-window rings work
    unchanged: a ring entry this chunk overwrites (position p - W) is
    masked for every query that could see the gathered stale value. The
    chunk's k/v then scatter into the pool token by token, pad lanes
    redirected to the trash page.

    Returns (x, new k_pos row)."""
    S = x.shape[1]
    dev = x.device
    ps = page_size
    W = tbl_row.shape[0] * ps                          # padded ring width
    i = torch.arange(S, dtype=torch.int32, device=dev)
    own_pos = pos + i
    real = i < clen
    io = BlockIO(mode="prefill",
                 positions=_positions_for(cfg, S, dev, offset=pos,
                                          batch=batch),
                 q_pos=own_pos,
                 k_pos=torch.cat([k_pos_row, torch.where(real, own_pos, -1)]))
    ring_slot = torch.remainder(own_pos, W).to(torch.int64)
    tbl = tbl_row.to(torch.int64)
    w_page = torch.where(real, tbl[ring_slot // ps], 0)   # pads -> trash
    w_off = ring_slot % ps
    for li in range(cfg.n_layers):
        pool_k, pool_v = pool_kv["k"][li], pool_kv["v"][li]
        ring = (W,) + tuple(pool_k.shape[2:])
        io.cache = {"k_pre": pool_k[tbl].reshape(ring),
                    "v_pre": pool_v[tbl].reshape(ring)}
        x, cache, _ = apply_block(_layer(params["blocks"], li), x, io, cfg,
                                  engine_of_layer(engine, li))
        pool_k[w_page, w_off] = cache["k"][0].to(pool_k.dtype)
        pool_v[w_page, w_off] = cache["v"][0].to(pool_v.dtype)
    new_row = k_pos_row.clone()
    new_row[ring_slot[:clen]] = own_pos[:clen].to(new_row.dtype)
    return x, new_row


def run_stack_decode(params, x, cfg: ModelConfig, engine, cache, batch=None):
    """One-token step. x: [B,1,d]. Returns (x, new_cache).

    ``cur`` is either a scalar (lockstep batch) or int [B] (per-slot);
    ``k_pos`` correspondingly [W] or [B, W]; the returned cache keeps the
    structure it was given. The layers' k/v are updated in place.

    Paged contract (the cache carries ``page_tbl`` [B, n]): logical ring
    slot ``cur % W`` lives at page ``page_tbl[b, slot // ps]``, offset
    ``slot % ps``; decode scatters one token through the table and
    gathers the row's W keys back out, all on the device. With
    ``batch["write_mask"]`` [B] bool (paged only), masked rows keep their
    cache bit for bit: their k/v writes land on the trash page, their
    k_pos row is untouched and their ``cur`` does not advance. The chunked-prefill
    engine decodes while some slots are mid-prefill; without the mask
    every decode step would scribble ring slots their chunks have yet to
    fill.

    A Mamba layer's ``conv`` / ``ssm`` state advances in place for every
    row, masked or not, as in the reference (a masked row is dead or not
    yet admitted; its next insert overwrites the state). Under M-RoPE
    the text positions advance all three sections per slot, unless
    ``batch`` carries ``mrope_positions``."""
    B = x.shape[0]
    cur = cache["cur"]
    per_slot = cur.dim() > 0
    cur_b = cur if per_slot else cur.expand(B)                     # [B]
    k_pos_vec = cache.get("k_pos")
    W = k_pos_vec.shape[-1] if k_pos_vec is not None else 1
    slot = torch.remainder(cur_b, W).to(torch.int64)
    tbl = cache.get("page_tbl")
    wm = batch.get("write_mask") if (tbl is not None and batch) else None
    lcache_extra = {"slot": slot}
    if tbl is not None:
        ps = cache["layers"]["k"].shape[2]                 # [L,P,ps,KV,hd]
        tbl64 = tbl.to(torch.int64)
        page = torch.gather(tbl64, 1, (slot // ps)[:, None])[:, 0]
        if wm is not None:
            page = torch.where(wm, page, 0)
        lcache_extra = {"page": page, "off": slot % ps, "page_tbl": tbl64}
    if cfg.rope_kind == "mrope" and batch and "mrope_positions" in batch:
        positions = batch["mrope_positions"]
    else:
        positions = cur_b[:, None].to(torch.int32)                 # [B, 1]
        if cfg.rope_kind == "mrope":
            positions = positions[..., None].expand(B, 1, 3)
    k_pos_new = None
    if k_pos_vec is not None:
        kp = k_pos_vec if k_pos_vec.dim() == 2 \
            else k_pos_vec[None, :].expand(B, W)
        upd = torch.arange(W, device=x.device)[None, :] == slot[:, None]
        if wm is not None:
            upd = upd & wm[:, None]
        k_pos_new = torch.where(upd, cur_b[:, None].to(kp.dtype), kp)
    layers = cache["layers"]
    for i in range(cfg.n_layers):
        lcache = {name: t[i] for name, t in layers.items()}
        lcache.update(lcache_extra)
        io = BlockIO(mode="decode", positions=positions, q_pos=cur_b,
                     k_pos=k_pos_new, cache=lcache)
        x, out, _ = apply_block(_layer(params["blocks"], i), x, io, cfg,
                                engine_of_layer(engine, i))
        for name in ("conv", "ssm"):
            if name in out:
                layers[name][i].copy_(out[name])
    adv = 1 if wm is None else wm.to(cur.dtype)
    new_cache = {"layers": layers, "cur": cur + adv}
    if k_pos_new is not None:
        new_cache["k_pos"] = (k_pos_new if (per_slot or k_pos_vec.dim() == 2)
                              else k_pos_new[0])
    if tbl is not None:
        new_cache["page_tbl"] = tbl
    return x, new_cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ssm_spec(cfg: ModelConfig, rows: int, cdt) -> dict:
    """Mamba state of ``rows`` slots (none for attention-only stacks):
    conv [L, rows, ck-1, di] in the compute dtype, ssm [L, rows, di, N]
    in f32."""
    if not (cfg.use_mamba or cfg.parallel_mamba):
        return {}
    L, di = cfg.n_layers, cfg.d_inner_
    return {"conv": _meta((L, rows, cfg.conv_kernel - 1, di), cdt),
            "ssm": _meta((L, rows, di, cfg.ssm_state), torch.float32)}


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               per_slot: bool = False):
    """The slot cache's shapes and dtypes as tensors on the meta device.
    ``per_slot=True`` gives the continuous-batching layout: every row has
    its own position (``cur`` [B], ``k_pos`` [B, W])."""
    cdt = dtype or dtype_of(cfg)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    W = cache_capacity(cfg, seq_len)
    layers = {}
    if _has_kv(cfg):
        layers["k"] = _meta((L, batch, W, KV, hd), cdt)
        layers["v"] = _meta((L, batch, W, KV, hd), cdt)
    layers.update(_ssm_spec(cfg, batch, cdt))
    lead = (batch,) if per_slot else ()
    spec = {"layers": layers, "cur": _meta(lead, torch.int32)}
    if _has_kv(cfg):
        spec["k_pos"] = _meta(lead + (W,), torch.int32)
    return spec


def cache_axes(cfg: ModelConfig, per_slot: bool = False):
    """Logical axes tree matching ``cache_spec``."""
    layers: dict[str, Any] = {}
    if _has_kv(cfg):
        layers["k"] = ("layer", "batch", "seq", "act_kv", None)
        layers["v"] = ("layer", "batch", "seq", "act_kv", None)
    if cfg.use_mamba or cfg.parallel_mamba:
        layers["conv"] = ("layer", "batch", None, "act_dinner")
        layers["ssm"] = ("layer", "batch", "act_dinner", None)
    axes = {"layers": layers, "cur": ("batch",) if per_slot else ()}
    if _has_kv(cfg):
        axes["k_pos"] = ("batch", None) if per_slot else (None,)
    return axes


def _materialize(spec, device, shardings=None):
    """Zero tensors of ``spec``'s dtypes on ``device`` (each leaf this
    rank's block of it under ``shardings``), every ``k_pos`` -1
    (masked)."""

    def one(t, sh=None):
        shape = tuple(t.shape) if sh is None else sh.local_shape(t.shape)
        return torch.zeros(shape, dtype=t.dtype, device=device)

    cache = tree_map(one, spec, *([shardings] if shardings else []))
    if "k_pos" in cache:
        cache["k_pos"].fill_(-1)
    return cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               per_slot: bool = False, device="cuda", shardings=None):
    """Zero-filled cache (serving from scratch). Per-slot caches start
    fully invalid: cur = 0, every k_pos = -1 (masked). A pure-SSM stack's
    cache is its Mamba state and ``cur`` alone. With ``shardings`` (a
    tree of ``partition.Sharding`` over ``cache_axes``) each leaf is this
    rank's block."""
    return _materialize(cache_spec(cfg, batch, seq_len, per_slot=per_slot),
                        device, shardings)


def pages_per_slot(cfg: ModelConfig, seq_len: int, page_size: int) -> int:
    """Logical pages per decode slot: the ring capacity rounded up to
    whole pages. The paged ring width is pages_per_slot * page_size;
    padding the ring is free because attention validity is decided by
    the mask (k_pos), not by the width."""
    return -(-cache_capacity(cfg, seq_len) // page_size)


def paged_cache_spec(cfg: ModelConfig, slots: int, n_pages: int,
                     page_size: int, seq_len: int, dtype=None):
    """The paged cache's shapes and dtypes as tensors on the meta device:
    one shared k/v page pool [L, n_pages, page_size, KV, hd] plus per-slot
    page tables [slots, pages_per_slot]; a hybrid stack's Mamba state
    stays per slot beside the pool. A pure-SSM stack has nothing to page
    and raises."""
    if not _has_kv(cfg):
        raise ValueError(f"{cfg.name}: paged cache requires a KV ring "
                         "(pure-SSM stacks have nothing to page)")
    cdt = dtype or dtype_of(cfg)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    n_slot = pages_per_slot(cfg, seq_len, page_size)
    layers = {"k": _meta((L, n_pages, page_size, KV, hd), cdt),
              "v": _meta((L, n_pages, page_size, KV, hd), cdt)}
    layers.update(_ssm_spec(cfg, slots, cdt))
    return {"layers": layers,
            "cur": _meta((slots,), torch.int32),
            "k_pos": _meta((slots, n_slot * page_size), torch.int32),
            "page_tbl": _meta((slots, n_slot), torch.int32)}


def paged_cache_axes(cfg: ModelConfig):
    """Logical axes tree matching ``paged_cache_spec``: the pool dim is
    "pages" (host-addressed like slots), heads shard as the slot cache's."""
    layers: dict[str, Any] = {
        "k": ("layer", "pages", "seq", "act_kv", None),
        "v": ("layer", "pages", "seq", "act_kv", None),
    }
    if cfg.use_mamba or cfg.parallel_mamba:
        layers["conv"] = ("layer", "batch", None, "act_dinner")
        layers["ssm"] = ("layer", "batch", "act_dinner", None)
    return {"layers": layers, "cur": ("batch",), "k_pos": ("batch", None),
            "page_tbl": ("batch", None)}


def init_paged_cache(cfg: ModelConfig, slots: int, n_pages: int,
                     page_size: int, seq_len: int, device="cuda",
                     shardings=None):
    """Zero page pool; every page table entry points at the trash page
    (physical page 0), every k_pos is -1 (masked) and every ``cur`` is 0.
    ``shardings`` as in ``init_cache``."""
    return _materialize(paged_cache_spec(cfg, slots, n_pages, page_size,
                                         seq_len), device, shardings)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def loss_fn(params, batch, cfg: ModelConfig, engine: ActivationEngine,
            remat: str = "block", z_loss: float = 1e-4, fsdp=None):
    """Next-token loss of one batch ({"tokens", "labels"} [B, S]):
    nll + aux + z_loss * mean(lse^2), with the f32 head. Returns (total,
    {"nll", "aux"}), 0-d f32 tensors. On a mesh with a data axis
    ``batch`` is the rank's rows and the loss the global one: the means
    are data means (``dp.mean``), the aux global (``layers._route``);
    ``fsdp`` gathers the FSDP leaves at use."""
    if fsdp is not None:
        params = fsdp.gather_top(params)
    engine = _bind_engine(engine, params)
    x = embed_tokens(params, batch["tokens"], cfg, batch.get("patch_embeds"))
    x, aux = run_stack_train(params, x, cfg, engine, remat, batch=batch,
                             fsdp=fsdp)
    x = apply_norm(params["ln_f"], x, cfg)
    logits = lm_logits(params, x, cfg)                     # f32
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    nll = dp.mean((lse - ll).mean())
    total = nll + aux + z_loss * dp.mean((lse ** 2).mean())
    return total, {"nll": nll, "aux": aux}


def forward_fn(params, batch, cfg: ModelConfig, engine: ActivationEngine):
    """Full-sequence logits, no cache (tests / evaluation)."""
    engine = _bind_engine(engine, params)
    x = embed_tokens(params, batch["tokens"], cfg, batch.get("patch_embeds"))
    x, _ = run_stack_train(params, x, cfg, engine, remat="none", batch=batch)
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
    x = embed_tokens(params, tokens, cfg, batch.get("patch_embeds"))
    x, cache = run_stack_prefill(params, x, cfg, engine, capacity,
                                 lengths=lengths, batch=batch)
    x = apply_norm(params["ln_f"], x, cfg)
    if lengths is None:
        last = x[:, -1:]
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        last = x[rows, (lengths - 1).to(torch.int64)][:, None]   # [B, 1, d]
    logits = lm_logits(params, last, cfg)[:, 0]
    return logits, cache


def prefill_prefix_fn(params, batch, cfg: ModelConfig,
                      engine: ActivationEngine, prefix_kv, prefix_len: int,
                      capacity: int, page_size: int):
    """Prefix-cached admission step: ragged prefill of prompt suffixes
    over a shared page-aligned prefix (run_stack_prefill_prefix). Logits
    are read at each row's last real *suffix* token; the returned cache
    covers only the suffix (page-shaped k/v) — prefix pages are already
    in the pool and are never rewritten."""
    lengths = batch["lengths"]
    engine = _bind_engine(engine, params)
    x = embed_tokens(params, batch["tokens"], cfg, batch.get("patch_embeds"))
    x, cache = run_stack_prefill_prefix(params, x, cfg, engine, prefix_kv,
                                        prefix_len, capacity, page_size,
                                        lengths, batch=batch)
    x = apply_norm(params["ln_f"], x, cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, (lengths - 1).to(torch.int64)][:, None]       # [B, 1, d]
    return lm_logits(params, last, cfg)[:, 0], cache


def prefill_chunk_fn(params, batch, cfg: ModelConfig,
                     engine: ActivationEngine, pool_kv, tbl_row, k_pos_row,
                     pos: int, clen: int, page_size: int):
    """Chunked-admission step: one chunk of one slot's prompt resumed at
    offset ``pos`` (run_stack_prefill_chunk; the pool is written in
    place). Logits are read at the chunk's last real token — meaningful
    only on the final chunk, where the engine samples the first generated
    token from them. Returns (logits [1, V], new k_pos row)."""
    engine = _bind_engine(engine, params)
    x = embed_tokens(params, batch["tokens"], cfg,
                     batch.get("patch_embeds"))                   # [1, S, d]
    x, new_row = run_stack_prefill_chunk(params, x, cfg, engine, pool_kv,
                                         tbl_row, k_pos_row, pos, clen,
                                         page_size, batch=batch)
    x = apply_norm(params["ln_f"], x, cfg)
    last = x[:, clen - 1:clen]                                    # [1, 1, d]
    return lm_logits(params, last, cfg)[:, 0], new_row


def decode_fn(params, batch, cache, cfg: ModelConfig, engine: ActivationEngine):
    """One decode step. A paged cache honours ``batch["write_mask"]``
    (run_stack_decode)."""
    engine = _bind_engine(engine, params)
    x = embed_tokens(params, batch["tokens"], cfg,
                     batch.get("patch_embeds"))            # [B, 1, d]
    x, cache = run_stack_decode(params, x, cfg, engine, cache, batch=batch)
    x = apply_norm(params["ln_f"], x, cfg)
    return lm_logits(params, x, cfg)[:, 0], cache
