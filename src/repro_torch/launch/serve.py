"""Batched serving launcher on the continuous-batching engine
(counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]

``serve_batch`` is a thin wrapper over ``ServeEngine``: prompts become
engine requests, decode runs as on-device chunks with on-device sampling,
and the returned tokens/stats follow the reference's lockstep contract.
The weights are random (``materialize_params``, torch's generator) and
the prompts are drawn with numpy from ``--seed``; neither matches the
reference's ``jax.random`` draws. The engine serves on the paged cache
by default (``--cache slot`` for per-slot rings; ``--page-size``,
``--no-prefix-cache``, ``--chunk-prefill``, ``--token-budget`` shape the
paged path). Flags of parts not yet ported (``--model-parallel``,
``--replicas``, ``--autoscale``, ...) raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import model as M
from repro_torch.serve import EngineConfig, ServeEngine


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    n_prompts: int
    prompt_len: int
    generated: int          # tokens emitted per prompt (incl. prefill sample)
    decode_steps: int       # sequential decode steps actually run
    decode_tokens: int      # tokens emitted by decode steps
    planes: int = 1         # codebook count K of the served arch

    @property
    def prefill_tokens_per_s(self):
        # a path that skipped prefill leaves prefill_s exactly 0.0
        if not self.prefill_s:
            return 0.0
        return self.n_prompts * self.prompt_len * self.planes / self.prefill_s

    @property
    def decode_tokens_per_s(self):
        # gen=1 workloads run zero decode steps, leaving decode_s 0.0
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


def _mask_after_eos(tokens: np.ndarray, eos_id: int) -> np.ndarray:
    """Right-pad each row with 0 after its first ``eos_id`` (the eos itself
    is kept) — the engine's ragged-completion contract. tokens [B, gen]
    or [B, gen, K] (eos tested on codebook 0)."""
    head = tokens[..., 0] if tokens.ndim == 3 else tokens        # [B, gen]
    is_eos = head == eos_id
    seen = np.cumsum(is_eos, axis=1)
    keep = (seen == 0) | (is_eos & (seen == 1))   # up to & incl. first eos
    if tokens.ndim == 3:
        keep = keep[..., None]
    return np.where(keep, tokens, 0).astype(tokens.dtype)


def serve_batch(cfg, params, prompts, gen_tokens: int, *,
                temperature: float = 0.0, seed: int = 0,
                capacity: int | None = None, slots: int | None = None,
                chunk: int = 8, eos_id: int | None = None,
                cache: str = "paged", page_size: int = 16,
                prefix_cache: bool = True, chunk_prefill: int = 0,
                token_budget: int | None = None, device="cuda"):
    """prompts: int [B, S]. Returns (tokens int32 [B, gen] on the CPU,
    stats). Always a continuous-batching ServeEngine on ``device``
    (``cache`` / ``page_size`` / ``prefix_cache`` pick its cache contract,
    ``chunk_prefill`` / ``token_budget`` its token-budget schedule). An
    explicit ``capacity`` overrides the default S + gen_tokens cache
    sizing (it must still fit every request). With ``eos_id``, rows that
    emit it stop early and are right-padded with 0 to gen_tokens."""
    prompts = np.asarray(prompts)
    B, S = prompts.shape[0], prompts.shape[1]
    max_len = S + gen_tokens
    if capacity is not None:
        if capacity < max_len:
            raise ValueError(
                f"capacity {capacity} < prompt_len + gen_tokens "
                f"({S} + {gen_tokens}): requests could not finish")
        max_len = capacity
    ecfg = EngineConfig(slots=slots or B, max_prompt_len=S, max_len=max_len,
                        chunk=max(1, min(chunk, gen_tokens - 1) or 1),
                        cache=cache, page_size=page_size,
                        prefix_cache=prefix_cache,
                        chunk_prefill=chunk_prefill,
                        token_budget=token_budget, seed=seed)
    engine = ServeEngine(cfg, params, ecfg, device=device)
    for b in range(B):
        engine.submit(prompts[b], gen_tokens, temperature=temperature,
                      eos_id=eos_id)
    done = engine.run()
    rows = np.zeros((B, gen_tokens), np.int32)             # 0-padded ragged
    for c in done:
        rows[c.uid, :len(c.tokens)] = np.asarray(c.tokens, np.int32)
    st = engine.stats
    return torch.from_numpy(rows), ServeStats(
        st.prefill_s, st.decode_s, B, S, gen_tokens,
        decode_steps=st.decode_steps, decode_tokens=st.decode_tokens)


# flag -> (default, ROADMAP item) of reference flags not ported yet
_UNPORTED_FLAGS = {
    "model_parallel": (1, "Queue A item 12"),
    "replicas": (1, "Queue A item 10"),
    "autoscale": (None, "Queue A item 10"),
    "router_queue": (64, "Queue A item 10"),
    "router_policy": ("reject", "Queue A item 10"),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen3-0.6b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--activation", default=None,
                   help="engine impl override (exact|cr|pwl|poly|rational|"
                        "region|taylor|base2, or an integer datapath "
                        "cr_fixed|pwl_fixed|poly_fixed|rational_fixed)")
    p.add_argument("--act-impl", default=None,
                   help="approximant scheme override for the serving "
                        "engine (cr_spline|pwl|poly|rational, or "
                        "<scheme>_fixed)")
    p.add_argument("--act-impl-kernel", action="store_true",
                   help="with --act-impl: use_kernel=True (one kernel "
                        "launch per nonlinearity)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slots", type=int, default=None,
                   help="decode slots (default = batch)")
    p.add_argument("--chunk", type=int, default=8,
                   help="decode steps per host sync")
    p.add_argument("--eos-id", type=int, default=None,
                   help="stop rows early on this token id")
    p.add_argument("--cache", choices=("paged", "slot"), default="paged",
                   help="KV cache contract: shared page pool (default) "
                        "or per-slot rings")
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page (--cache paged)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable prefix page sharing (--cache paged)")
    p.add_argument("--chunk-prefill", type=int, default=0,
                   help="prompt tokens per prefill chunk; > 0 switches "
                        "the engine to the token-budget schedule that "
                        "interleaves chunked prefill with decode "
                        "(--cache paged)")
    p.add_argument("--token-budget", type=int, default=None,
                   help="token budget per engine iteration (requires "
                        "--chunk-prefill; default slots*chunk + "
                        "chunk_prefill)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, or cpu)")
    p.add_argument("--json", default=None, help="write stats JSON here")
    # reference flags of parts not yet ported: accepted, raise if set
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--autoscale", default=None)
    p.add_argument("--router-queue", type=int, default=64)
    p.add_argument("--router-policy", default="reject")
    args = p.parse_args(argv)

    for name, (default, item) in _UNPORTED_FLAGS.items():
        if getattr(args, name) != default:
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet "
                             f"(ROADMAP.md, {item})")
    cfg = registry.get(args.arch, smoke=args.smoke)
    if args.activation:
        cfg = dataclasses.replace(
            cfg, activation=dataclasses.replace(cfg.activation,
                                                impl=args.activation))
    if args.act_impl_kernel and not args.act_impl:
        raise SystemExit("--act-impl-kernel requires --act-impl <scheme>")
    if args.act_impl:
        from repro_torch.configs.common import act_impl_of
        cfg = act_impl_of(cfg, args.act_impl,
                          use_kernel=True if args.act_impl_kernel else None)
    act_tag = cfg.activation.tag()
    if cfg.act_impl:
        act_tag += f" (act_impl={cfg.act_impl})"
    print(f"[serve] arch={cfg.name} act={act_tag} device={args.device}")

    params = M.materialize_params(cfg, seed=args.seed, device=args.device)
    # serving precision: bf16 weights, as the reference's launcher casts
    params = _tree_cast(params, torch.bfloat16)
    rng = np.random.RandomState(args.seed)
    prompts = rng.randint(0, min(cfg.vocab_size, 4096),
                          (args.batch, args.prompt_len)).astype(np.int32)
    tokens, stats = serve_batch(
        cfg, params, prompts, args.gen, temperature=args.temperature,
        seed=args.seed, slots=args.slots, chunk=args.chunk,
        eos_id=args.eos_id, cache=args.cache, page_size=args.page_size,
        prefix_cache=not args.no_prefix_cache,
        chunk_prefill=args.chunk_prefill, token_budget=args.token_budget,
        device=args.device)
    print(f"[serve] prefill {stats.prefill_tokens_per_s:,.0f} tok/s "
          f"({stats.prefill_s*1e3:.0f} ms), decode "
          f"{stats.decode_tokens_per_s:,.0f} tok/s "
          f"({stats.decode_s*1e3:.0f} ms for {stats.decode_steps} steps, "
          f"{args.batch} seqs) on {args.device}")
    print("[serve] sample output tokens:", tokens[0, :16].tolist())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dataclasses.asdict(stats), f, indent=2)
    return stats


def _tree_cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tree_cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


if __name__ == "__main__":
    main()
