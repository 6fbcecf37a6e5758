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
paged path). Every assigned ``--arch`` serves; a multi-codebook arch
(musicgen-large) takes [B, S, K] prompts and returns [B, gen, K] tokens.
``--replicas N`` (N > 1) or ``--autoscale MIN:MAX`` serves through the
multi-replica ``Router`` (``serve_routed``: in-process engines sharing
one copy of the weights, a bounded router queue under
``--router-queue`` / ``--router-policy``).

``--model-parallel N`` (N > 1) serves tensor-parallel: ``main`` spawns N
rank processes itself (``launch/mesh.py::spawn_ranks``), each builds the
same weights and the same engine on a (1, N) mesh and keeps its shards;
rank 0 prints. ``--dist-backend`` picks the process group's backend:
``nccl`` by default on CUDA (a card per rank), ``gloo`` on the CPU; ranks
that share one card need ``--dist-backend gloo``, and ``nccl`` there
raises. Every TP run prints its backend.

    python -m repro_torch.launch.serve --smoke --model-parallel 2 \
        --dist-backend gloo [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.parallel import partition as part
from repro_torch.serve import (AutoscaleConfig, EngineConfig,
                               InProcessReplica, Router, RouterConfig,
                               ServeEngine)
from repro_torch.serve.engine import _to_device


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
                token_budget: int | None = None, mesh=None,
                rules: dict | None = None, device="cuda"):
    """prompts: int [B, S], or [B, S, K] for K codebooks. Returns (tokens
    int32 [B, gen] or [B, gen, K] on the CPU, stats). Always a
    continuous-batching ServeEngine on ``device`` (with ``mesh``, this
    rank's part of a tensor-parallel engine: every rank of the mesh
    makes the same call)
    (``cache`` / ``page_size`` / ``prefix_cache`` pick its cache contract,
    ``chunk_prefill`` / ``token_budget`` its token-budget schedule). An
    explicit ``capacity`` overrides the default S + gen_tokens cache
    sizing (it must still fit every request). With ``eos_id``, rows that
    emit it (on codebook 0 for K > 1) stop early and are right-padded
    with 0 to gen_tokens."""
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
    engine = ServeEngine(cfg, params, ecfg, mesh=mesh, rules=rules,
                         device=device)
    for b in range(B):
        engine.submit(prompts[b], gen_tokens, temperature=temperature,
                      eos_id=eos_id)
    done = engine.run()
    K = cfg.n_codebooks
    rows = np.zeros((B, gen_tokens, K) if K > 1 else (B, gen_tokens),
                    np.int32)                              # 0-padded ragged
    for c in done:
        rows[c.uid, :len(c.tokens)] = np.asarray(c.tokens, np.int32)
    st = engine.stats
    return torch.from_numpy(rows), ServeStats(
        st.prefill_s, st.decode_s, B, S, gen_tokens,
        decode_steps=st.decode_steps, decode_tokens=st.decode_tokens,
        planes=K)


def serve_routed(cfg, params, prompts, gen_tokens: int, *,
                 replicas: int = 2, queue_limit: int = 64,
                 policy: str = "reject", autoscale=None,
                 temperature: float = 0.0, seed: int = 0,
                 slots: int | None = None, chunk: int = 8,
                 eos_id: int | None = None, mesh=None,
                 rules: dict | None = None, device="cuda", **engine_kw):
    """Serve ``prompts`` through the multi-replica Router: N in-process
    ``ServeEngine`` replicas on ``device`` behind load-aware dispatch, a
    bounded router queue, and optionally the stats-driven autoscaler
    (``autoscale=AutoscaleConfig(...)``). The weights are moved to the
    device and cast to the compute dtype once, here, so every replica
    (those the autoscaler adds too) holds the same tensors: one copy.
    With ``mesh`` every replica is this rank's part of a tensor-parallel
    engine, and the one copy is this rank's shards (every rank of the
    mesh makes the same call).

    ``prompts`` is int [B, S] ([B, S, K] for K codebooks: they route
    exactly like scalar streams, replicas are engines), or a list of B
    prompts of any lengths (``stats.prompt_len`` is then the longest;
    ``router.engine_totals()`` counts the real tokens).

    Returns (tokens int32 [B, gen] or [B, gen, K] on the CPU, stats,
    router): row b holds request b's tokens; rows the router shed or
    rejected under backpressure stay all zero (shed uids appear in
    ``router.completions`` with finish_reason="shed"); ``stats``
    aggregates the surviving fleet's engine counters."""
    if not isinstance(prompts, (list, tuple)):
        prompts = list(np.asarray(prompts))
    B, S = len(prompts), max(len(p) for p in prompts)
    ecfg = EngineConfig(slots=slots or max(1, B // max(replicas, 1)),
                        max_prompt_len=S, max_len=S + gen_tokens,
                        chunk=max(1, min(chunk, gen_tokens - 1) or 1),
                        seed=seed, **engine_kw)
    if mesh is not None:
        psh, _, _ = steps_mod.serve_shardings(
            cfg, ecfg.slots, ecfg.max_len, mesh, part.serve_rules(rules))
        params = M.shard_params(params, cfg, psh)
    shared = M.compute_params(_to_device(params, torch.device(device)), cfg)

    def factory(rid):
        return InProcessReplica(ServeEngine(cfg, shared, ecfg, mesh=mesh,
                                            rules=rules, device=device))

    router = Router(factory, RouterConfig(
        replicas=replicas, queue_limit=queue_limit, policy=policy,
        autoscale=autoscale))
    # a rejected request takes no uid, so the uids after it do not count
    # rows: keep each accepted one's row
    row_of = {}
    for b in range(B):
        uid = router.submit(prompts[b], gen_tokens, temperature=temperature,
                            eos_id=eos_id)
        if uid is not None:
            row_of[uid] = b
    done = router.run()
    K = cfg.n_codebooks
    rows = np.zeros((B, gen_tokens, K) if K > 1 else (B, gen_tokens),
                    np.int32)
    for c in done:
        if c.tokens:
            rows[row_of[c.uid], :len(c.tokens)] = np.asarray(c.tokens,
                                                             np.int32)
    st = router.engine_totals()
    return torch.from_numpy(rows), ServeStats(
        st.prefill_s, st.decode_s, B, S, gen_tokens,
        decode_steps=st.decode_steps, decode_tokens=st.decode_tokens,
        planes=K), router


def _parse_autoscale(spec: str | None):
    """--autoscale MIN:MAX -> AutoscaleConfig (None passes through)."""
    if spec is None:
        return None
    try:
        lo, hi = (int(x) for x in spec.split(":"))
    except ValueError:
        raise SystemExit(f"--autoscale wants MIN:MAX, got {spec!r}")
    return AutoscaleConfig(min_replicas=lo, max_replicas=hi)


# flag -> (default, ROADMAP item) of reference flags not ported yet
_UNPORTED_FLAGS: dict = {}


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
    p.add_argument("--replicas", type=int, default=1,
                   help="> 1: serve through the multi-replica Router "
                        "(in-process engine replicas, load-aware "
                        "dispatch; one copy of the weights)")
    p.add_argument("--router-queue", type=int, default=64,
                   help="bounded router admission queue (backpressure)")
    p.add_argument("--router-policy", choices=("reject", "shed"),
                   default="reject",
                   help="queue-full policy: reject the newcomer or shed "
                        "the oldest queued request")
    p.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                   help="enable the stats-driven autoscaler with this "
                        "replica range (implies the router path)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, or cpu)")
    p.add_argument("--json", default=None, help="write stats JSON here")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="> 1: tensor-parallel over this many spawned rank "
                        "processes (rank 0 prints)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend of --model-parallel (default "
                        "nccl on cuda, gloo on cpu; ranks sharing one card "
                        "need gloo)")
    args = p.parse_args(argv)

    for name, (default, item) in _UNPORTED_FLAGS.items():
        if getattr(args, name) != default:
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet "
                             f"(ROADMAP.md, {item})")
    if args.model_parallel < 1:
        raise SystemExit("--model-parallel must be >= 1")
    if args.model_parallel == 1:
        return _serve(args)
    backend = args.dist_backend or mesh_mod.default_backend(args.device)
    try:
        mesh_mod.check_backend(backend, args.device, args.model_parallel)
    except ValueError as e:
        raise SystemExit(f"--dist-backend {backend}: {e}")
    return mesh_mod.spawn_ranks(_serve_rank, args.model_parallel,
                                backend=backend, device=args.device,
                                args=(args,))[0]


def _serve_rank(rank, world, device, args):
    """One rank of ``main --model-parallel N``: the same run on a (1, N)
    mesh; rank 0 prints and writes ``--json``."""
    mesh = mesh_mod.make_host_mesh(1, world, device=device.type)
    return _serve(args, mesh=mesh, device=device, rank=rank)


def _serve(args, mesh=None, device=None, rank=0):
    device = device or args.device
    say = print if rank == 0 else (lambda *a, **k: None)
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
    tp_tag = "" if mesh is None else (
        f" mesh={part.mesh_shape(mesh)} backend="
        f"{torch.distributed.get_backend()}")
    say(f"[serve] arch={cfg.name} act={act_tag} "
        f"codebooks={cfg.n_codebooks} device={device}{tp_tag}")

    params = M.materialize_params(cfg, seed=args.seed, device=device)
    # serving precision: bf16 weights, as the reference's launcher casts
    params = _tree_cast(params, torch.bfloat16)
    rng = np.random.RandomState(args.seed)
    planes = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    prompts = rng.randint(0, min(cfg.vocab_size, 4096),
                          (args.batch, args.prompt_len) + planes
                          ).astype(np.int32)
    cache_kw = dict(cache=args.cache, page_size=args.page_size,
                    prefix_cache=not args.no_prefix_cache,
                    chunk_prefill=args.chunk_prefill,
                    token_budget=args.token_budget)
    router = None
    if args.replicas > 1 or args.autoscale:
        tokens, stats, router = serve_routed(
            cfg, params, prompts, args.gen, replicas=args.replicas,
            queue_limit=args.router_queue, policy=args.router_policy,
            autoscale=_parse_autoscale(args.autoscale),
            temperature=args.temperature, seed=args.seed, slots=args.slots,
            chunk=args.chunk, eos_id=args.eos_id, mesh=mesh, device=device,
            **cache_kw)
        rs = router.stats
        say(f"[serve] router: {rs.completed}/{rs.submitted} completed "
            f"(shed {rs.shed}, rejected {rs.rejected}) over "
            f"{len(router.replicas)} replicas "
            f"(peak {rs.replica_peak}, +{rs.scale_ups}/-{rs.scale_downs} "
            f"scale actions)")
    else:
        tokens, stats = serve_batch(
            cfg, params, prompts, args.gen, temperature=args.temperature,
            seed=args.seed, slots=args.slots, chunk=args.chunk,
            eos_id=args.eos_id, mesh=mesh, device=device, **cache_kw)
    say(f"[serve] prefill {stats.prefill_tokens_per_s:,.0f} tok/s "
        f"({stats.prefill_s*1e3:.0f} ms), decode "
        f"{stats.decode_tokens_per_s:,.0f} tok/s "
        f"({stats.decode_s*1e3:.0f} ms for {stats.decode_steps} steps, "
        f"{args.batch} seqs) on {device}")
    say("[serve] sample output tokens:", tokens[0, :16].tolist())
    if args.json and rank == 0:
        doc = dataclasses.asdict(stats)
        doc["tokens"] = tokens.tolist()
        if router is not None:
            doc["router"] = dataclasses.asdict(router.stats)
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
    return stats


def _tree_cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tree_cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


if __name__ == "__main__":
    main()
