"""Model building blocks: RoPE and M-RoPE, the dense block, MoE, Mamba-1
and the hybrid (parallel attention + Mamba) block (counterpart of
``repro/models/layers.py``).

Plain functions on tensors over a nested-dict parameter tree with the
reference's key paths. Every nonlinearity routes through the configured
ActivationEngine. Attention runs in plain torch with f32 scores: a
flash-style online softmax over KV chunks inside a loop over Q chunks
(the reference's doubly-chunked ``lax.scan``), so long prefills keep
bounded temporaries. GQA head h is served by kv-head h // G. Mamba's
selective scan is a loop over the sequence with an f32 state carry (the
reference's ``lax.scan``).

Tensor parallelism: a block takes a rank's shards of its weights
(``model.shard_params``) and computes on them; a weight's local shape
against the config's full dim tells whether that dim is sharded. Where a
sharded dim is contracted (``wo`` over heads, ``w_down`` over ``mlp``,
Mamba's ``x_proj`` / ``out_proj`` over ``dinner``) the product is
row-parallel (``parallel/tp.py``: f32 partials summed over the group);
an expert-sharded router's logits are gathered. Where a replicated
activation enters a column-parallel product (``wq`` / ``wk`` / ``wv``,
``w_gate`` / ``w_up`` and so ``glu_2d``'s ``x``, Mamba's ``in_proj`` and
the ``x_proj`` output its channels read, an expert-sharded router, the
vocab-parallel head) it passes ``tp.enter``, whose backward sums the
ranks' partial gradients (training). With whole weights (TP=1) every
path is the unsharded one and no collective runs.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.activations import ActivationEngine
from repro_torch.parallel import dp, tp

from .config import ModelConfig

NEG_INF = -1.0e30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


# ---------------------------------------------------------------------------
# init (same initializer scales and key paths as the reference)
# ---------------------------------------------------------------------------

def _init(gen, shape, scale=None, device="cuda"):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, device=device) * scale


def init_norm(cfg: ModelConfig, device, d: int | None = None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((d,), device=device)}
    return {}  # layernorm_np: non-parametric (olmo)


def init_attention(gen, cfg: ModelConfig, device):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": _init(gen, (d, h, hd), device=device),
        "wk": _init(gen, (d, kvh, hd), device=device),
        "wv": _init(gen, (d, kvh, hd), device=device),
        "wo": _init(gen, (h, hd, d), scale=1.0 / math.sqrt(h * hd),
                    device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), device=device)
        p["bk"] = torch.zeros((kvh, hd), device=device)
        p["bv"] = torch.zeros((kvh, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device)
        p["k_norm"] = torch.ones((hd,), device=device)
    return p


def init_mlp(gen, cfg: ModelConfig, device):
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.glu:
        p["w_gate"] = _init(gen, (d, f), device=device)
    p["w_up"] = _init(gen, (d, f), device=device)
    p["w_down"] = _init(gen, (f, d), device=device)
    return p


def init_moe(gen, cfg: ModelConfig, device):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": _init(gen, (d, e), device=device),
        "w_gate": _init(gen, (e, d, f), scale=1.0 / math.sqrt(d),
                        device=device),
        "w_up": _init(gen, (e, d, f), scale=1.0 / math.sqrt(d),
                      device=device),
        "w_down": _init(gen, (e, f, d), scale=1.0 / math.sqrt(f),
                        device=device),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, cfg, device)
    return p


def init_mamba(gen, cfg: ModelConfig, device):
    """Mamba-1 parameters: S4D-real ``A_log`` (log 1..N on every channel)
    and ``dt_proj_b`` the inverse softplus of a log-uniform step in
    [1e-3, 1e-1], as the reference's."""
    d, di, N, dtr, ck = (cfg.d_model, cfg.d_inner_, cfg.ssm_state,
                         cfg.dt_rank_, cfg.conv_kernel)
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((di,), generator=gen, device=device)
                   * (hi - lo) + lo)
    return {
        "in_proj": _init(gen, (d, 2 * di), device=device),
        "conv_w": _init(gen, (ck, di), scale=1.0 / math.sqrt(ck),
                        device=device),
        "conv_b": torch.zeros((di,), device=device),
        "x_proj": _init(gen, (di, dtr + 2 * N), device=device),
        "dt_proj_w": _init(gen, (dtr, di), device=device),
        "dt_proj_b": torch.log(torch.expm1(dt)),
        "A_log": torch.log(A),
        "D": torch.ones((di,), device=device),
        "out_proj": _init(gen, (di, d), scale=1.0 / math.sqrt(di),
                          device=device),
    }


def init_block(gen, cfg: ModelConfig, device):
    p: dict[str, Any] = {"ln1": init_norm(cfg, device)}
    if cfg.use_mamba:
        p["mamba"] = init_mamba(gen, cfg, device)
    elif cfg.parallel_mamba:
        p["attn"] = init_attention(gen, cfg, device)
        p["mamba"] = init_mamba(gen, cfg, device)
        p["ln_attn_out"] = init_norm(cfg, device)
        p["ln_mamba_out"] = init_norm(cfg, device)
    else:
        p["attn"] = init_attention(gen, cfg, device)
    if cfg.has_ffn:
        p["ln2"] = init_norm(cfg, device)
        p["ffn"] = (init_moe(gen, cfg, device) if cfg.n_experts > 0
                    else init_mlp(gen, cfg, device))
    return p


# ---------------------------------------------------------------------------
# logical axes of every parameter (the reference's boxes), for sharding
# ---------------------------------------------------------------------------

def norm_axes(cfg: ModelConfig):
    return {"scale": ("embed",)} if cfg.norm == "rmsnorm" else {}


def attention_axes(cfg: ModelConfig):
    p = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv", "head_dim"),
         "wv": ("embed", "kv", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        p.update(bq=("heads", "head_dim"), bk=("kv", "head_dim"),
                 bv=("kv", "head_dim"))
    if cfg.qk_norm:
        p.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return p


def mlp_axes(cfg: ModelConfig):
    p = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.glu:
        p["w_gate"] = ("embed", "mlp")
    return p


def moe_axes(cfg: ModelConfig):
    p = {"router": ("embed", "expert"),
         "w_gate": ("expert", "embed", "mlp"),
         "w_up": ("expert", "embed", "mlp"),
         "w_down": ("expert", "mlp", "embed")}
    if cfg.shared_expert:
        p["shared"] = mlp_axes(cfg)
    return p


def mamba_axes(cfg: ModelConfig):
    return {"in_proj": ("embed", "dinner"), "conv_w": ("conv", "dinner"),
            "conv_b": ("dinner",), "x_proj": ("dinner", "dt"),
            "dt_proj_w": ("dt", "dinner"), "dt_proj_b": ("dinner",),
            "A_log": ("dinner", "state"), "D": ("dinner",),
            "out_proj": ("dinner", "embed")}


def block_axes(cfg: ModelConfig):
    """The axes tree of ``init_block``'s parameters (one layer)."""
    p: dict[str, Any] = {"ln1": norm_axes(cfg)}
    if cfg.use_mamba:
        p["mamba"] = mamba_axes(cfg)
    elif cfg.parallel_mamba:
        p["attn"] = attention_axes(cfg)
        p["mamba"] = mamba_axes(cfg)
        p["ln_attn_out"] = norm_axes(cfg)
        p["ln_mamba_out"] = norm_axes(cfg)
    else:
        p["attn"] = attention_axes(cfg)
    if cfg.has_ffn:
        p["ln2"] = norm_axes(cfg)
        p["ffn"] = moe_axes(cfg) if cfg.n_experts > 0 else mlp_axes(cfg)
    return p


def _on_shards(engine):
    """``engine`` for computation on the rank's shards: its bound
    approximant params (``params["act"]``) pass ``tp.enter``, since their
    gradient there is the rank's part of the whole one."""
    if getattr(engine, "act_params", None) is None:
        return engine
    return ActivationEngine(engine.cfg, act_params=tp.enter(
        engine.act_params))


def _down(h, w, full: int, matmul=torch.matmul):
    """``matmul(h, w)`` contracting a dim of full size ``full``: as it is
    when ``w`` holds all of it, row-parallel when ``w`` holds a rank's
    block."""
    if w.shape[-2] == full:
        return matmul(h, w)
    return tp.row_parallel(h, w, matmul)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"]
    else:  # non-parametric layernorm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head RMSNorm over head_dim (qwen3 qk-norm)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (rotate halves) and M-RoPE
# ---------------------------------------------------------------------------

def _inv_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


def rope_freqs(cfg: ModelConfig):
    return _inv_freqs(cfg.head_dim_, cfg.rope_theta)


@functools.lru_cache(maxsize=None)
def _inv_freqs_on(hd: int, theta: float, device: torch.device):
    """``rope_freqs`` as f32 on ``device``, copied there once: a copy from
    host memory makes the host wait for the device, and the decode loop
    must enqueue its steps without waiting."""
    return torch.as_tensor(_inv_freqs(hd, theta), dtype=torch.float32,
                           device=device)


@functools.lru_cache(maxsize=None)
def _mrope_sections_on(sections: tuple, device: torch.device):
    """M-RoPE section of each of the hd/2 frequencies (0 = t, 1 = h,
    2 = w: ``sections[i]`` consecutive frequencies each) on ``device``,
    copied there once (see ``_inv_freqs_on``)."""
    sec = np.concatenate([np.full((n,), i) for i, n in enumerate(sections)])
    return torch.as_tensor(sec, dtype=torch.int64, device=device)


def apply_rope(x, positions, cfg: ModelConfig):
    """x: [..., S, H, hd]; positions: [B_or_1, S] (RoPE) or [B_or_1, S, 3]
    (M-RoPE, qwen2-vl: frequency f rotates by the t / h / w position of
    its section). Rotation in f32."""
    if cfg.rope_kind == "none":
        return x
    hd = cfg.head_dim_
    inv = _inv_freqs_on(hd, cfg.rope_theta, x.device)           # [hd/2]
    if cfg.rope_kind == "mrope":
        sec = _mrope_sections_on(tuple(cfg.mrope_sections), x.device)
        pos = positions.to(torch.float32)[..., sec]             # [B, S, hd/2]
        angles = pos * inv
    else:
        angles = positions.to(torch.float32)[..., None] * inv   # [B, S, hd/2]
    cos = torch.cos(angles)[..., None, :]                       # [B, S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : hd // 2], xf[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, flash-style chunked, SWA, qk-norm, bias, softcap)
# ---------------------------------------------------------------------------

def _proj(x, w, cdt):
    """x [B, S, d] @ w [d, *out] in the compute dtype -> [B, S, *out]."""
    w = w.to(cdt)
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(x.shape[:-1] + tuple(w.shape[1:]))


def _enter_heads(params, x, cfg: ModelConfig):
    """(params, x) as the rank's attention reads them. With its heads
    sharded, ``x`` enters column-parallel products, and the leaves it
    holds whole serve only its own heads (``q_norm`` / ``k_norm``, and
    the kv projections where the kv heads stay whole, ``kv_group``): all
    pass ``tp.enter``, so their gradients are the group's sums."""
    if params["wq"].shape[1] == cfg.n_heads:
        return params, x
    whole = {"q_norm", "k_norm"}
    if params["wk"].shape[1] == cfg.n_kv_heads:
        whole |= {"wk", "wv", "bk", "bv"}
    return ({k: tp.enter(v) if k in whole else v
             for k, v in params.items()}, tp.enter(x))


def _qkv(params, x, positions, cfg: ModelConfig):
    cdt = dtype_of(cfg)
    params, x = _enter_heads(params, x, cfg)
    q = _proj(x, params["wq"], cdt)
    k = _proj(x, params["wk"], cdt)
    v = _proj(x, params["wv"], cdt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(cdt)
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_head_norm(params["q_norm"], q)
        k = rms_head_norm(params["k_norm"], k)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    return q, k, v


def _flash_chunk_scan(q, k, v, q_pos, k_pos, cfg: ModelConfig, engine):
    """Online-softmax attention for one Q chunk over all KV chunks.
    q: [B, qc, H, hd]; k/v: [B, S, H, hd] (GQA heads pre-expanded);
    positions int. Returns [B, qc, H, hd]."""
    B, qc, H, hd = q.shape
    S = k.shape[1]
    kc = min(cfg.kv_chunk, S)
    if S % kc:
        raise ValueError(f"KV length {S} is not a multiple of {kc}")
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(torch.float32) * scale
    acc = torch.zeros((B, H, qc, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
    for c0 in range(0, S, kc):
        kb = k[:, c0:c0 + kc].to(torch.float32)
        vb = v[:, c0:c0 + kc].to(torch.float32)
        kp = k_pos[c0:c0 + kc]
        s = torch.einsum("bqhx,bkhx->bhqk", qf, kb)
        mask = kp[None, :] <= q_pos[:, None]                # causal [qc, kc]
        if cfg.sliding_window is not None:
            mask &= kp[None, :] > q_pos[:, None] - cfg.sliding_window
        mask &= (kp >= 0)[None, :]                          # ring validity
        if cfg.logit_softcap:
            s = cfg.logit_softcap * engine.tanh(s / cfg.logit_softcap)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhx->bhqx", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]        # [B,H,qc,hd]
    return out.transpose(1, 2).to(q.dtype)                  # [B,qc,H,hd]


def expand_kv_heads(kv, G: int):
    """GQA -> flat heads: [B, S, KV, hd] -> [B, S, KV*G, hd], head h
    served by kv-head h // G."""
    if G == 1:
        return kv
    return torch.repeat_interleave(kv, G, dim=2)


def flash_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig, engine):
    """Doubly-chunked causal attention.
    q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd] (expanded to H internally).
    q_pos: [Sq] absolute positions; k_pos: [Skv] (-1 = invalid slot)."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qc = min(cfg.q_chunk, Sq)
    kc = min(cfg.kv_chunk, Skv)
    pq = (-Sq) % qc
    pk = (-Skv) % kc
    if pq:   # pad query rows are sliced off after
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = torch.nn.functional.pad(q_pos, (0, pq), value=0)
    if pk:   # pad keys get position -1 => masked out
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        k_pos = torch.nn.functional.pad(k_pos, (0, pk), value=-1)
    G = H // k.shape[2]
    k = expand_kv_heads(k, G)
    v = expand_kv_heads(v, G)
    outs = [_flash_chunk_scan(q[:, i:i + qc], k, v, q_pos[i:i + qc], k_pos,
                              cfg, engine)
            for i in range(0, q.shape[1], qc)]
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :Sq] if pq else out


def decode_attention(q, k_cache, v_cache, q_pos, k_pos, cfg: ModelConfig,
                     engine):
    """Single-token attention over the cache. q: [B, 1, H, hd];
    k/v_cache: [B, W, KV, hd]; q_pos: [B] per-slot query positions;
    k_pos: [B, W] per-slot absolute key positions (-1 empty)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).to(torch.float32) / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(torch.float32))
    mask = (k_pos <= q_pos[:, None]) & (k_pos >= 0)         # [B, W]
    if cfg.sliding_window is not None:
        mask &= k_pos > q_pos[:, None] - cfg.sliding_window
    if cfg.logit_softcap:
        s = cfg.logit_softcap * engine.tanh(s / cfg.logit_softcap)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention_out(params, ctx, cfg: ModelConfig):
    cdt = dtype_of(cfg)
    wo = params["wo"].to(cdt)                               # [H, hd, d]
    B, S = ctx.shape[:2]
    return _down(ctx.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]),
                 cfg.n_heads * cfg.head_dim_)


def kv_group(p, cfg: ModelConfig):
    """The kv heads a rank's own q heads read, as a slice of the whole kv
    heads, when heads shard over the TP group and kv heads do not (KV
    does not divide by the group); None when every kv head held is read
    (TP=1, or kv sharded with the heads). Local head j is global head
    h0 + j, served by kv head (h0 + j) // G; the slice's heads must serve
    the local heads in equal runs."""
    h_loc, kv_loc = p["wq"].shape[1], p["wk"].shape[1]
    if h_loc == cfg.n_heads or kv_loc != cfg.n_kv_heads:
        return None
    G = cfg.n_heads // cfg.n_kv_heads
    h0 = tp.current().rank * h_loc
    kv0, kv1 = h0 // G, (h0 + h_loc - 1) // G + 1
    g_loc = h_loc // (kv1 - kv0)
    if any((h0 + j) // G - kv0 != j // g_loc for j in range(h_loc)):
        raise ValueError(
            f"{cfg.name}: the {h_loc} heads of a rank do not read their kv "
            f"heads in equal runs (H={cfg.n_heads}, KV={cfg.n_kv_heads}); "
            "this layout needs a per-head kv gather")
    return slice(kv0, kv1)


# ---------------------------------------------------------------------------
# MLP / GLU
# ---------------------------------------------------------------------------

def mlp_fusable(cfg: ModelConfig, engine: ActivationEngine) -> bool:
    """fuse_mlp preconditions: a gated FFN whose activation exists as an
    epilogue, under an approximant-scheme engine."""
    from repro_torch.kernels.epilogue import EPILOGUES
    return (cfg.fuse_mlp and cfg.glu and cfg.mlp_act in EPILOGUES
            and engine.act_impl is not None)


def apply_mlp(params, x, cfg: ModelConfig, engine: ActivationEngine):
    cdt = dtype_of(cfg)
    if params["w_up"].shape[-1] != cfg.d_ff:       # column-parallel
        x, engine = tp.enter(x), _on_shards(engine)
    if mlp_fusable(cfg, engine):
        # one kernel: gate/up matmuls + approximant epilogue on the f32
        # accumulator — the gate projection never round-trips to memory
        from repro_torch.kernels import epilogue as epi, ops as kernel_ops
        ecfg = engine.cfg
        # a bound engine's tanh params ride into the kernel; the
        # softplus epilogue reads its own residual table instead
        bound = None if cfg.mlp_act == "softplus" else engine.act_params
        table = epi.table_for(cfg.mlp_act, ecfg.x_max, ecfg.depth) \
            if engine.act_impl == "cr_spline" else None
        h = kernel_ops.fused_glu(
            x, params["w_gate"].to(cdt), params["w_up"].to(cdt), table,
            act=cfg.mlp_act,
            method=None if table is not None else engine.act_impl,
            depth=ecfg.depth, x_max=ecfg.x_max, degree=ecfg.degree,
            params=bound)
    else:
        up = x @ params["w_up"].to(cdt)
        if cfg.glu:
            gate = x @ params["w_gate"].to(cdt)
            h = engine(cfg.mlp_act, gate) * up
        else:
            h = engine(cfg.mlp_act, up)
    return _down(h, params["w_down"].to(cdt), cfg.d_ff)


# ---------------------------------------------------------------------------
# MoE: token-choice top-k; capacity-bounded (gshard) or dropless (ragged)
# ---------------------------------------------------------------------------

def _top_k(probs, k: int):
    """(values, indices) of the k largest probabilities, the lower index
    first on a tie, as ``jax.lax.top_k`` (``torch.topk`` promises no
    order among ties): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router, x, k: int, e: int):
    """f32 router: softmax over the experts, top-k, the k weights
    renormalized, and the GShard load-balancing aux over all tokens: its
    per-expert means taken over the data ranks' tokens too before their
    product (``dp.mean``), so every rank holds the global aux.
    x: [..., d]. Returns (top_w [..., k], top_i [..., k], aux)."""
    sharded = router.shape[-1] != e             # expert-sharded router
    if sharded:
        x = tp.enter(x)
    logits = x.to(torch.float32) @ router.to(torch.float32)
    if sharded:
        logits = tp.gather_last(logits, e)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    lead = tuple(range(probs.dim() - 1))
    me = dp.mean(probs.mean(dim=lead))
    ce_frac = dp.mean(torch.nn.functional.one_hot(top_i, e)
                      .to(torch.float32).sum(dim=-2).mean(dim=lead))
    return top_w, top_i, e * torch.sum(me * ce_frac)


def _expert_ffn(params, xe, cfg: ModelConfig, engine, matmul):
    """The experts' FFN on their dispatched rows through ``matmul(x, w)``
    (a batched product over [E, rows, d] or a grouped one); the
    activation goes through the engine (the reference routes it there,
    not through the fused GLU kernel)."""
    cdt = dtype_of(cfg)
    if params["w_up"].shape[-1] != cfg.d_ff:       # column-parallel
        xe, engine = tp.enter(xe), _on_shards(engine)
    up = matmul(xe, params["w_up"].to(cdt))
    if cfg.glu:
        gate = matmul(xe, params["w_gate"].to(cdt))
        h = engine(cfg.mlp_act, gate) * up
    else:
        h = engine(cfg.mlp_act, up)
    return _down(h, params["w_down"].to(cdt), cfg.d_ff, matmul)


def apply_moe(params, x, cfg: ModelConfig, engine: ActivationEngine):
    if cfg.moe_impl == "gshard":
        return apply_moe_gshard(params, x, cfg, engine)
    return apply_moe_ragged(params, x, cfg, engine)


def apply_moe_gshard(params, x, cfg: ModelConfig, engine: ActivationEngine):
    """GShard/Switch-style capacity-bounded MoE, the reference's grouping,
    capacity and drops, with index dispatch and combine.

    Rows are cut into dispatch groups of ``g = min(moe_group_size, S)``
    tokens (S itself when g does not divide it); each expert takes at
    most C = ceil(g * capacity_factor / E) tokens a group and slot, at
    running positions shared across the k slots (slot 0 first); a token
    past C is dropped (weight 0). The reference dispatches and combines
    with one-hot einsums, each of whose output elements holds exactly
    one nonzero term; here each token is scattered to its row
    (expert, group, position) of the [E, B, C, d] expert input, dropped
    ones to a trash row, and its expert output is gathered back and
    weighted. Same numbers in f32, the k slots added to ``y`` in the
    reference's order. x: [B, S, d]."""
    cdt = dtype_of(cfg)
    B0, S0, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    g = min(cfg.moe_group_size, S0)
    if S0 % g:
        g = S0
    xg = x.reshape(B0 * (S0 // g), g, d)
    B, S, _ = xg.shape
    cap = int(math.ceil(S * cfg.capacity_factor / e))
    top_w, top_i, aux = _route(params["router"], xg, k, e)

    dev = x.device
    rows = e * B * cap                        # rows of the expert input
    group = torch.arange(B, device=dev)[:, None]
    x_rows = xg.reshape(B * S, d).to(cdt)
    y = torch.zeros((B, S, d), dtype=torch.float32, device=dev)
    pos_base = torch.zeros((B, e), dtype=torch.int64, device=dev)
    for slot in range(k):
        idx = top_i[..., slot]                                # [B, S]
        oh_e = torch.nn.functional.one_hot(idx, e)            # [B, S, E]
        pos = torch.cumsum(oh_e, dim=1) - 1 + pos_base[:, None, :]
        pos_tok = torch.gather(pos, 2, idx[..., None])[..., 0]
        keep = pos_tok < cap
        pos_base = pos_base + oh_e.sum(dim=1)
        # row (expert, group, position) of the [E, B, C] expert input;
        # dropped tokens land on the trash row past the end
        dest = torch.where(keep, (idx * B + group) * cap + pos_tok, rows)
        dest = dest.reshape(-1)
        xe = torch.zeros((rows + 1, d), dtype=cdt, device=dev) \
            .index_copy(0, dest, x_rows)[:rows].reshape(e, B * cap, d)
        out_e = _expert_ffn(params, xe, cfg, engine, torch.matmul)
        got = out_e.reshape(rows, d).index_select(
            0, torch.clamp(dest, max=rows - 1)).reshape(B, S, d)
        w = top_w[..., slot] * keep                           # dropped: 0
        y = y + got.to(torch.float32) * w[..., None]

    out = y.to(x.dtype).reshape(B0, S0, d)
    if cfg.shared_expert:
        out = out + apply_mlp(params["shared"], x, cfg, engine)
    return out, cfg.router_aux_weight * aux


def _grouped_matmul(xs, w, group_sizes):
    """``jax.lax.ragged_dot``: rows of ``xs`` [T, d] sorted by group, group
    j's ``group_sizes[j]`` rows times ``w[j]`` [d, f], in the promoted
    type of the two operands: one grouped GEMM (``torch._grouped_mm``, a
    library GEMM as the reference leaves ragged_dot to XLA) with the
    offsets on the device, so no host sync. On the H100 under torch 2.11
    it takes f32, bf16 and f16 (chip_smoke.py's ``grouped_mm`` line)."""
    dt = torch.promote_types(xs.dtype, w.dtype)
    offs = torch.cumsum(group_sizes, dim=0).to(torch.int32)
    return torch._grouped_mm(xs.to(dt), w.to(dt), offs=offs)


def apply_moe_ragged(params, x, cfg: ModelConfig, engine: ActivationEngine):
    """Token-choice top-k with mixtral-style renormalized softmax over the
    selected experts; dropless sort-based dispatch: the (token, expert)
    pairs sorted by expert (stably), one grouped GEMM per projection, the
    weighted expert outputs added back per token. x: [B, S, d]."""
    B, S, d = x.shape
    T = B * S
    k, e = cfg.top_k, cfg.n_experts
    xt = x.reshape(T, d)
    top_w, top_i, aux = _route(params["router"], xt, k, e)

    flat_expert = top_i.reshape(-1)                           # [T*k]
    sort_idx = torch.argsort(flat_expert, stable=True)
    token_idx = (torch.arange(T * k, device=x.device) // k)[sort_idx]
    xs = xt.index_select(0, token_idx)                         # [T*k, d]
    group_sizes = torch.nn.functional.one_hot(flat_expert, e).sum(dim=0)
    out_s = _expert_ffn(params, xs, cfg, engine,
                        lambda a, w: _grouped_matmul(a, w, group_sizes))
    w_sorted = top_w.reshape(-1)[sort_idx].to(out_s.dtype)
    combined = torch.zeros((T, d), dtype=out_s.dtype, device=x.device) \
        .index_add(0, token_idx, out_s * w_sorted[:, None])
    out = combined.reshape(B, S, d).to(x.dtype)
    if cfg.shared_expert:
        out = out + apply_mlp(params["shared"], x, cfg, engine)
    return out, cfg.router_aux_weight * aux


# ---------------------------------------------------------------------------
# Mamba-1 (selective SSM): falcon-mamba, and hymba's parallel branch
# ---------------------------------------------------------------------------

# time steps the selective scan runs, set by a cost count only
# (analysis/hlo_cost.py::count_cell: the scan's cost is affine in its trip
# count, so counts at two short trip counts give it at any S); None runs
# every step
SCAN_TRIPS: int | None = None


def _mamba_inner(params, xz, conv_state, ssm_state, cfg: ModelConfig,
                 engine: ActivationEngine):
    """The Mamba core over a sequence chunk. xz: [B, S, 2*di]; conv_state:
    [B, ck-1, di] (compute dtype); ssm_state: [B, di, N] (f32). Returns
    (y [B, S, di], new conv_state, new ssm_state).

    The depthwise causal conv runs over [conv_state; x] with its ck terms
    added in the reference's order. The selective scan is a loop over S
    with the f32 carry h [B, di, N]: each step forms its own
    dA = exp(dt * A) and dt * x * B, so nothing of size [B, S, di, N]
    exists at once."""
    N, dtr, ck = cfg.ssm_state, cfg.dt_rank_, cfg.conv_kernel
    di = params["conv_w"].shape[1]        # d_inner, or a rank's block of it
    S = xz.shape[1]
    f32 = torch.float32
    xin, z = xz[..., :di], xz[..., di:]
    xpad = torch.cat([conv_state.to(xin.dtype), xin], dim=1)  # [B, S+ck-1, di]
    conv_w = params["conv_w"].to(xin.dtype)                   # [ck, di]
    xc = sum(xpad[:, i:i + S] * conv_w[i] for i in range(ck))
    xc = xc + params["conv_b"].to(xin.dtype)
    new_conv_state = xpad[:, S:] if ck > 1 else conv_state
    xc = engine.silu(xc)

    # input-dependent SSM parameters (x_proj contracts d_inner)
    proj = _down(xc, params["x_proj"].to(xc.dtype), cfg.d_inner_)
    if di != cfg.d_inner_:      # read by this rank's channels alone
        proj = tp.enter(proj)
    dt_in, Bc, Cc = proj[..., :dtr], proj[..., dtr:dtr + N], proj[..., dtr + N:]
    dt = dt_in @ params["dt_proj_w"].to(xc.dtype)
    dt = engine.softplus(dt.to(f32) + params["dt_proj_b"])   # [B, S, di]
    A = -torch.exp(params["A_log"])                          # [di, N]
    dtx = dt * xc.to(f32)
    Bf, Cf = Bc.to(f32), Cc.to(f32)
    h = ssm_state.to(f32)
    ys = []
    trips = S if SCAN_TRIPS is None else min(S, SCAN_TRIPS)
    for t in range(trips):
        dA = torch.exp(dt[:, t, :, None] * A)                 # [B, di, N]
        h = dA * h + dtx[:, t, :, None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    # a cost count's short scan: the steps not run leave placeholders
    ys.extend(torch.empty_like(ys[0]) for _ in range(S - trips))
    y = torch.stack(ys, dim=1)                               # [B, S, di]
    y = y + xc.to(f32) * params["D"]
    y = y * engine.silu(z.to(f32))
    return y.to(xz.dtype), new_conv_state, h


def apply_mamba(params, x, cfg: ModelConfig, engine, conv_state=None,
                ssm_state=None):
    """Full-sequence Mamba block from the carried state (zeros when none).
    Returns (out [B, S, d], conv_state, ssm_state)."""
    cdt = dtype_of(cfg)
    B = x.shape[0]
    di, ck, N = params["conv_w"].shape[1], cfg.conv_kernel, cfg.ssm_state
    if conv_state is None:
        conv_state = torch.zeros((B, ck - 1, di), dtype=cdt, device=x.device)
    if ssm_state is None:
        ssm_state = torch.zeros((B, di, N), dtype=torch.float32,
                                device=x.device)
    if di != cfg.d_inner_:                         # column-parallel
        x, engine = tp.enter(x), _on_shards(engine)
    xz = x @ params["in_proj"].to(cdt)
    y, conv_state, ssm_state = _mamba_inner(params, xz, conv_state,
                                            ssm_state, cfg, engine)
    return (_down(y, params["out_proj"].to(cdt), cfg.d_inner_), conv_state,
            ssm_state)


# ---------------------------------------------------------------------------
# transformer block (dense / moe / mamba / hymba-parallel)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockIO:
    """What a block consumes/produces besides the hidden state."""
    positions: Any = None        # [B?, S] or [B, S, 3] (mrope)
    q_pos: Any = None            # [S] (train/prefill) or [B] (decode,
                                 # per-slot) absolute query positions
    k_pos: Any = None            # [S] (train/prefill) or [B, W] (decode,
                                 # per-slot) absolute key positions
    mode: str = "train"          # train | prefill | decode
    cache: dict | None = None    # per-layer cache slices (decode/prefill out)
    aux_loss: Any = 0.0


def _attn_branch(p, xn, io: BlockIO, cfg: ModelConfig, engine):
    """One layer's attention branch (qkv, cache write, page gather,
    attention, out projection), in the span ``model.attention``."""
    with spans.span("model.attention"):
        return _attention(p, xn, io, cfg, engine)


def _attention(p, xn, io: BlockIO, cfg: ModelConfig, engine):
    new_cache = {}
    if cfg.logit_softcap and p["wq"].shape[1] != cfg.n_heads:
        engine = _on_shards(engine)       # the softcap of the rank's heads
    # heads sharded, kv heads whole: the cache keeps every kv head, each
    # rank's attention reads those of its own q heads
    sel = kv_group(p, cfg)

    def mine(kv):
        return kv if sel is None else kv[:, :, sel]

    if io.mode == "decode":
        q, k_new, v_new = _qkv(p, xn, io.positions, cfg)
        kc, vc = io.cache["k"], io.cache["v"]
        if "page_tbl" in io.cache:
            # paged contract: k/v are views of the shared page pool
            # [P, ps, KV, hd], written in place; the row's ring is
            # reassembled by gathering its page table. Writes of dead or
            # unallocated rows land on the trash page (page 0), which
            # k_pos == -1 masks out.
            page, off = io.cache["page"], io.cache["off"]      # [B]
            tbl = io.cache["page_tbl"]                         # [B, n]
            kc[page, off] = k_new[:, 0].to(kc.dtype)
            vc[page, off] = v_new[:, 0].to(vc.dtype)
            B, n = tbl.shape
            ring = (B, n * kc.shape[1]) + tuple(kc.shape[2:])  # [B, W, KV, hd]
            ctx = decode_attention(q, mine(kc[tbl].reshape(ring)),
                                   mine(vc[tbl].reshape(ring)), io.q_pos,
                                   io.k_pos, cfg, engine)
        else:
            # slot contract: k/v [B, W, KV, hd] are views into the
            # stacked cache and are written in place (the reference
            # returns updated copies; in place saves a full cache copy
            # per step)
            rows = torch.arange(kc.shape[0], device=kc.device)
            slot = io.cache["slot"]                             # [B]
            kc[rows, slot] = k_new[:, 0].to(kc.dtype)
            vc[rows, slot] = v_new[:, 0].to(vc.dtype)
            ctx = decode_attention(q, mine(kc), mine(vc), io.q_pos,
                                   io.k_pos, cfg, engine)
        new_cache = {"k": kc, "v": vc}
    else:
        q, k, v = _qkv(p, xn, io.positions, cfg)
        if io.cache is not None and "k_pre" in io.cache:
            # prefix-cached prefill: suffix queries attend over the
            # shared prefix k/v (gathered from the page pool, the same
            # for every row) followed by this row's own suffix keys
            kp, vp = io.cache["k_pre"], io.cache["v_pre"]      # [Lp, KV, hd]
            B = k.shape[0]

            def full(pre, own):
                pre = pre.to(own.dtype)[None].expand((B,) + tuple(pre.shape))
                return torch.cat([pre, own], dim=1)

            ctx = flash_attention(q, mine(full(kp, k)), mine(full(vp, v)),
                                  io.q_pos, io.k_pos, cfg, engine)
        else:
            ctx = flash_attention(q, mine(k), mine(v), io.q_pos, io.k_pos,
                                  cfg, engine)
        if io.mode == "prefill":
            new_cache = {"k": k, "v": v}
    return attention_out(p, ctx, cfg), new_cache


def _mamba_branch(p, xn, io: BlockIO, cfg: ModelConfig, engine):
    """Mamba from the layer's carried state (decode, and a prefill handed
    one); in decode and prefill also the new state as cache entries."""
    cs = io.cache.get("conv") if io.cache else None
    ss = io.cache.get("ssm") if io.cache else None
    out, cs, ss = apply_mamba(p, xn, cfg, engine, cs, ss)
    return out, ({"conv": cs, "ssm": ss}
                 if io.mode in ("decode", "prefill") else {})


def apply_block(p, x, io: BlockIO, cfg: ModelConfig, engine):
    """Returns (x_out, new_cache_dict, aux_loss_increment)."""
    new_cache: dict[str, Any] = {}
    xn = apply_norm(p["ln1"], x, cfg)
    if cfg.use_mamba:
        out, mc = _mamba_branch(p["mamba"], xn, io, cfg, engine)
        new_cache.update(mc)
        x = x + out
    elif cfg.parallel_mamba:
        attn_out, ac = _attn_branch(p["attn"], xn, io, cfg, engine)
        mamba_out, mc = _mamba_branch(p["mamba"], xn, io, cfg, engine)
        new_cache.update(ac)
        new_cache.update(mc)
        # hymba: the mean of the per-branch normalized outputs
        x = x + 0.5 * (apply_norm(p["ln_attn_out"], attn_out, cfg)
                       + apply_norm(p["ln_mamba_out"], mamba_out, cfg))
    else:
        attn_out, ac = _attn_branch(p["attn"], xn, io, cfg, engine)
        new_cache.update(ac)
        x = x + attn_out
    aux = 0.0
    if cfg.has_ffn:
        xn2 = apply_norm(p["ln2"], x, cfg)
        if cfg.n_experts > 0:
            ffn_out, aux = apply_moe(p["ffn"], xn2, cfg, engine)
        else:
            ffn_out = apply_mlp(p["ffn"], xn2, cfg, engine)
        x = x + ffn_out
    return x, new_cache, aux
