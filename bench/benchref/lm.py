"""Plain PyTorch reference of the benchmark's decoder LMs, in float32 with
TF32 off, kept apart from the program: it imports nothing of it.

The architecture (one block a layer, pre-norm):

    h  = norm(x);  q, k, v = h Wq, h Wk, h Wv;  rotate q and k (RoPE,
         rotate-halves, f32 angles = position * theta^(-2i / hd))
    x += softmax(q k^T / sqrt(hd), causal, sliding window, GQA head h
         served by kv head h // (H / KV)) v  Wo
    h  = norm(x)
    x += silu(h Wg) * (h Wu) Wd                         (dense)
    x += sum over the top-k experts e of w_e * FFN_e(h)  (MoE: f32 router
         softmax over all experts, top-k by a stable descending sort, the
         k weights renormalised; aux = E * sum_e mean(p_e) * mean(picked_e))

with norm either RMSNorm with a scale or a layer norm without parameters
(eps 1e-6), silu the frozen Catmull-Rom unit (``crspline``), an f32
head over the padded vocabulary, and the training loss nll + aux +
z_loss * mean(lse^2).

Parameters come as the benchmark made them: a tree with the program's
key paths (blocks stacked on a leading layer axis). Every product goes
through a ``Precision``: ``f32`` (the reference) or ``fp8`` (the
control: each operand quantised to float8 e4m3 with one scale a tensor,
products accumulated in f32, a straight-through gradient).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import crspline

NEG_INF = -1.0e30
FP8_MAX = 448.0


def exact_f32() -> None:
    """Matmuls and convolutions in true f32 (no TF32) for every later call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Arch:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    padded_vocab: int
    norm: str                       # rmsnorm | layernorm_np
    rope_theta: float
    sliding_window: int | None = None
    n_experts: int = 0
    top_k: int = 2
    router_aux_weight: float = 0.01
    z_loss: float = 1e-4
    eps: float = 1e-6
    x_max: float = 4.0
    depth: int = 32

    @classmethod
    def of(cls, model: dict) -> "Arch":
        """From a configuration file's ``model`` section."""
        pad = model.get("vocab_pad_multiple", 256)
        vocab = -(-model["vocab_size"] // pad) * pad
        act = model.get("activation", {})
        return cls(n_layers=model["n_layers"], d_model=model["d_model"],
                   n_heads=model["n_heads"], n_kv_heads=model["n_kv_heads"],
                   head_dim=model["head_dim"], d_ff=model["d_ff"],
                   padded_vocab=vocab, norm=model["norm"],
                   rope_theta=float(model["rope_theta"]),
                   sliding_window=model.get("sliding_window"),
                   n_experts=model.get("n_experts", 0),
                   top_k=model.get("top_k", 2),
                   x_max=act.get("x_max", 4.0), depth=act.get("depth", 32))


class _QuantSTE(torch.autograd.Function):
    """fp8 e4m3 quantise-dequantise with one scale a tensor; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, t):
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """Every product of the reference: ``mm(a, b)`` = a @ b in f32, on
    fp8-quantised operands for ``fp8``."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r} (f32 | fp8)")
        self.name = name

    def q(self, t):
        return _QuantSTE.apply(t) if self.name == "fp8" else t

    def mm(self, a, b):
        return self.q(a.float()) @ self.q(b.float())


def norm(x, p, arch: Arch):
    if arch.norm == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + arch.eps) \
            * p["scale"].float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + arch.eps)


def rope(x, pos, arch: Arch):
    """x [B, S, H, hd]; pos [S] int."""
    hd = arch.head_dim
    inv = 1.0 / (arch.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                    device=x.device) / hd))
    ang = pos.float()[:, None] * inv.float()[None, :]       # [S, hd/2]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, pos, arch: Arch):
    """Causal (and windowed) softmax attention; q [B, S, H, hd], k / v
    [B, S, KV, hd]."""
    G = arch.n_heads // arch.n_kv_heads
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhx,bkhx->bhqk", q, k) / math.sqrt(arch.head_dim)
    mask = pos[None, :] <= pos[:, None]
    if arch.sliding_window is not None:
        mask &= pos[None, :] > pos[:, None] - arch.sliding_window
    s = torch.where(mask[None, None], s, NEG_INF)
    return torch.einsum("bhqk,bkhx->bqhx", torch.softmax(s, dim=-1), v)


def ffn(p, h, arch: Arch, pr: Precision, win):
    g = pr.mm(h, p["w_gate"])
    return pr.mm(crspline.silu(g, win, arch.x_max) * pr.mm(h, p["w_up"]),
                 p["w_down"])


def moe(p, h, arch: Arch, pr: Precision, win):
    B, S, d = h.shape
    E, K = arch.n_experts, arch.top_k
    xt = h.reshape(B * S, d)
    probs = torch.softmax(xt @ p["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[:, :K], idx[:, :K]
    w = w / w.sum(-1, keepdim=True)
    picked = torch.nn.functional.one_hot(idx, E).float().sum(-2)
    aux = E * torch.sum(probs.mean(0) * picked.mean(0))
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        pe = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
        y = y.index_add(0, tok, ffn(pe, xt[tok], arch, pr, win)
                        * w[tok, slot][:, None])
    return y.reshape(B, S, d), arch.router_aux_weight * aux


def block(lp, x, pos, arch: Arch, pr: Precision, win):
    """One layer: (x, aux). ``lp`` is the layer's parameters (any float
    type: cast to f32 at use)."""
    B, S, d = x.shape
    H, KV, hd = arch.n_heads, arch.n_kv_heads, arch.head_dim
    a = lp["attn"]
    h = norm(x, lp.get("ln1", {}), arch)
    q = pr.mm(h, a["wq"].reshape(d, H * hd)).view(B, S, H, hd)
    k = pr.mm(h, a["wk"].reshape(d, KV * hd)).view(B, S, KV, hd)
    v = pr.mm(h, a["wv"].reshape(d, KV * hd)).view(B, S, KV, hd)
    o = attention(rope(q, pos, arch), rope(k, pos, arch), v, pos, arch)
    x = x + pr.mm(o.reshape(B, S, H * hd), a["wo"].reshape(H * hd, d))
    h = norm(x, lp.get("ln2", {}), arch)
    if arch.n_experts:
        y, aux = moe(lp["ffn"], h, arch, pr, win)
    else:
        y, aux = ffn(lp["ffn"], h, arch, pr, win), torch.zeros((), device=x.device)
    return x + y, aux


def layer(blocks, i: int):
    """Layer i's subtree of a layer-stacked tree (views)."""
    if isinstance(blocks, dict):
        return {k: layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def windows_on(device, arch: Arch):
    return torch.as_tensor(crspline.tanh_windows(arch.x_max, arch.depth),
                           device=device)


# ---------------------------------------------------------------------------
# training: the loss, its gradients and AdamW
# ---------------------------------------------------------------------------

def loss(params, tokens, labels, arch: Arch, pr: Precision, win):
    """(total, nll) of one batch; each layer under activation
    checkpointing, so the reference fits beside its optimizer state."""
    from torch.utils.checkpoint import checkpoint
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens.long()].float()
    aux = torch.zeros((), device=x.device)
    for i in range(arch.n_layers):
        lp = layer(params["blocks"], i)
        x, a = checkpoint(lambda x_, lp_: block(lp_, x_, pos, arch, pr, win),
                          x, lp, use_reentrant=False)
        aux = aux + a
    h = norm(x, params.get("ln_f", {}), arch)
    logits = h @ params["lm_head"].float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - ll).mean()
    total = nll + aux / arch.n_layers + arch.z_loss * (lse ** 2).mean()
    return total, nll


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with a global-norm clip and a linear warm-up then cosine
    schedule (the defaults of a training job's step)."""
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def lr(self, step: int) -> float:
        if step < self.warmup_steps:
            return self.lr_peak * step / max(self.warmup_steps, 1)
        frac = min(max((step - self.warmup_steps)
                       / max(self.decay_steps - self.warmup_steps, 1), 0.0), 1.0)
        return self.lr_min + 0.5 * (self.lr_peak - self.lr_min) * (
            1.0 + math.cos(math.pi * frac))


def leaves(tree, prefix=""):
    """(path, tensor) of every leaf, in key order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def train(params, batches, arch: Arch, pr: Precision, opt: AdamW = AdamW(),
          frozen=("act",)):
    """Runs ``len(batches)`` steps from ``params`` (f32, updated in place)
    at steps 0, 1, ...; returns the losses, each trainable leaf's first
    gradient norm as the optimizer takes it (after the clip) and each
    leaf's change norm after the last step."""
    win = windows_on(params["embed"].device, arch)
    named = [(n, t) for n, t in leaves(params)
             if n.split(".")[0] not in frozen]
    start = [t.detach().clone() for _, t in named]
    m = [torch.zeros_like(t) for _, t in named]
    v = [torch.zeros_like(t) for _, t in named]
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches):
        ts = [_get(params, n).detach().requires_grad_() for n, _ in named]
        for (n, _), t in zip(named, ts):
            _set(params, n, t)
        total, _ = loss(params, tokens, labels, arch, pr, win)
        grads = torch.autograd.grad(total, ts)
        losses.append(float(total.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            grads = [g * scale for g in grads]
            if first is None:
                first = {n: float(g.norm()) for (n, _), g in zip(named, grads)}
            count = step + 1
            b1c = 1.0 - opt.b1 ** count
            b2c = 1.0 - opt.b2 ** count
            lr = opt.lr(step)
            for i, (g, t) in enumerate(zip(grads, ts)):
                m[i] = opt.b1 * m[i] + (1 - opt.b1) * g
                v[i] = opt.b2 * v[i] + (1 - opt.b2) * g * g
                upd = (m[i] / b1c) / (torch.sqrt(v[i] / b2c) + opt.eps) \
                    + opt.weight_decay * t
                _set(params, named[i][0], (t - lr * upd).detach())
        del grads, ts
    with torch.no_grad():
        change = {n: float((_get(params, n) - s).norm())
                  for (n, _), s in zip(named, start)}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def _get(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _set(tree, path, value):
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = value


# ---------------------------------------------------------------------------
# serving: the logits of served sequences, layer by layer
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_gaps(weights, seqs, arch: Arch, precisions=("f32",)):
    """For each (tokens, n_prompt, served) in ``seqs`` — the prompt, the
    served tokens, ``tokens`` the prompt followed by all but the last
    served token — the reference's logits at each position that chose a
    served token. Returns per precision, per sequence: ``served_gap`` (the
    f32 reference's best logit minus its logit of the served token, at
    every position) and, for a lower precision, ``top_gap`` (the same gap
    for the token that precision puts first). The layers run one at a
    time over every sequence, their weights cast to f32 once a layer."""
    dev = weights["embed"].device
    win = windows_on(dev, arch)
    prs = {name: Precision(name) for name in precisions}
    hs = {name: [weights["embed"][torch.as_tensor(t, device=dev).long()]
                 .float()[None] for t, _, _ in seqs] for name in precisions}
    for i in range(arch.n_layers):
        lp = _f32(layer(weights["blocks"], i))
        for name in precisions:
            for j, (t, _, _) in enumerate(seqs):
                pos = torch.arange(len(t), device=dev)
                hs[name][j], _ = block(lp, hs[name][j], pos, arch, prs[name],
                                       win)
        del lp
    head = weights["lm_head"].float()
    out = {name: [] for name in precisions}
    for j, (t, n_prompt, served) in enumerate(seqs):
        rows = slice(n_prompt - 1, n_prompt - 1 + len(served))
        ref = norm(hs["f32"][j][0, rows], weights.get("ln_f", {}), arch) @ head
        best = ref.max(-1).values
        tok = torch.as_tensor(served, device=dev).long()
        got = {"served_gap": (best - ref.gather(-1, tok[:, None])[:, 0])}
        for name in precisions:
            if name == "f32":
                out[name].append(got)
                continue
            low = norm(hs[name][j][0, rows], weights.get("ln_f", {}), arch) \
                @ prs[name].q(head)
            pick = low.argmax(-1)
            out[name].append({"top_gap": best - ref.gather(-1, pick[:, None])[:, 0]})
    return out


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()
