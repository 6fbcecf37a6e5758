"""Step builders (counterpart of ``repro/launch/steps.py``).

  train_step:         fwd + loss + bwd + clip + (optional int8 error-
                      feedback compression) + AdamW update;
  prefill_step:       forward, returns (last logits, filled cache);
  prefill_chunk_step: one chunk of one paged slot's prompt (chunked
                      admission);
  serve_step:         one-token decode against the cache;

and the serve engine's shardings on a tensor-parallel mesh
(``serve_shardings``).

The train step is functional (new params and state, the inputs left as
they were) and enqueues its work without waiting for the device: its
metrics are 0-d tensors on the device, and reading them on the host is
the caller's sync.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import approximant
from repro_torch.core.activations import ActivationEngine, LayerEngines
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compress
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import partition as part


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    remat: str = "block"          # none | block | dots
    grad_compression: bool = False
    z_loss: float = 1e-4
    skip_nonfinite: bool = True   # NaN/inf loss or grads -> keep the old
                                  # params and state
    microbatches: int = 1         # grad accumulation: split the batch dim
                                  # into n sequential microbatches; the
                                  # activations held shrink ~n-fold
    train_act: bool = False       # unfreeze the approximant params (the
                                  # params["act"] leaves; launch/train.py
                                  # --train-act). Frozen by default: grads
                                  # zeroed before the clip, params and
                                  # moments restored after the update, so
                                  # the datapath stays the registry build
    donate: bool = False          # update params and optimizer state in
                                  # place (the caller's trees are given
                                  # up, as jax.jit's donate_argnums gives
                                  # up buffers): one copy of both on the
                                  # device instead of two, the same
                                  # numbers. Port-only, for models whose
                                  # state fills the card (16 B a param)


def opt_state_axes(params_axes):
    return {
        "m": params_axes,
        "v": params_axes,
        "count": (),
    }


def _make_engine(cfg: ModelConfig) -> ActivationEngine | LayerEngines:
    """Engine for a step function, with the config contracts enforced at
    build time: a bogus ``act_impl`` or a malformed ``act_layers``
    assignment fails the build with the registered-scheme list, and a
    config that asks for ``fuse_mlp`` but cannot get it on every layer
    fails instead of silently running unfused. A uniform assignment is
    one ``ActivationEngine``; a mixed one a ``LayerEngines``."""
    try:
        layer_cfgs = cfg.layer_activation_configs()
        if len(set(layer_cfgs)) == 1:
            engine = ActivationEngine(layer_cfgs[0])
        else:
            engine = LayerEngines(layer_cfgs)
        if cfg.has_ffn and cfg.mlp_act == "softplus":
            for eng in getattr(engine, "distinct", (engine,)):
                if not eng.act_impl:
                    continue
                # the softplus epilogue reads the scheme's residual
                # params; a scheme with no residual build (rational)
                # fails the step build
                c = eng.cfg
                approximant.params_for(approximant.spec_for(
                    eng.act_impl, "softplus", x_max=c.x_max, depth=c.depth,
                    degree=c.degree), "softplus_res")
    except ValueError as e:
        raise ValueError(f"{cfg.name}: invalid activation config "
                         f"(act_impl={cfg.act_impl!r}, "
                         f"act_layers={cfg.act_layers!r}): {e}") from e
    if cfg.fuse_mlp:
        from repro_torch.models.layers import mlp_fusable
        for eng in getattr(engine, "distinct", (engine,)):
            if not mlp_fusable(cfg, eng):
                raise ValueError(
                    f"{cfg.name}: fuse_mlp=True requires glu=True, mlp_act "
                    f"in kernels.epilogue.EPILOGUES and an approximant-"
                    f"scheme activation engine on EVERY layer (got "
                    f"glu={cfg.glu}, mlp_act={cfg.mlp_act!r}, "
                    f"impl={eng.cfg.impl!r})")
    return engine


def make_train_step(cfg: ModelConfig, hyper: TrainHyper = TrainHyper()):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: ``batch`` is {"tokens", "labels"} [B, S] on the params'
    device, ``step`` a host int (or a 0-d tensor) that sets the learning
    rate, and the metrics (0-d tensors) are loss, nll, aux, gnorm, lr and,
    under ``skip_nonfinite``, skipped."""
    engine = _make_engine(cfg)

    def grads_of(params, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = M.loss_fn(p, batch, cfg, engine, remat=hyper.remat,
                                  z_loss=hyper.z_loss)
        leaves = tree_leaves(p)
        got = torch.autograd.grad(loss, leaves, allow_unused=True,
                                  materialize_grads=True)
        by_leaf = dict(zip(map(id, leaves), got))
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                tree_map(lambda t: by_leaf[id(t)], p))

    def accumulate(params, batch):
        """Sequential microbatch accumulation: grads, loss and metrics are
        the mean over microbatches (the same expectation as the monolithic
        step), summed in the reference's order."""
        n = hyper.microbatches
        rows = next(iter(batch.values())).shape[0] // n
        acc_g = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                               device=t.device), params)
        zero = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        acc_l, acc_m = zero, {"nll": zero, "aux": zero}
        for i in range(n):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            (loss_i, metrics_i), g_i = grads_of(params, mb)
            acc_g = tree_map(torch.add, acc_g, g_i)
            acc_l = acc_l + loss_i
            acc_m = tree_map(torch.add, acc_m, metrics_i)
        inv = 1.0 / n
        return ((acc_l * inv, tree_map(lambda v: v * inv, acc_m)),
                tree_map(lambda v: v * inv, acc_g))

    def donated_update(params, opt_state, grads, loss, step):
        """The update below, in place on ``params`` and ``opt_state``."""
        gnorm = adamw.clip_by_global_norm_(grads, hyper.opt.clip_norm)
        if hyper.grad_compression:
            grads, new_err = compress.compress_grads(grads,
                                                     opt_state["error"])
        lr = adamw.cosine_schedule(hyper.opt, step, loss.device)
        ok = (torch.isfinite(loss) & torch.isfinite(gnorm)
              if hyper.skip_nonfinite else None)
        adamw.adamw_update_(grads, opt_state, params, hyper.opt, lr, ok=ok,
                            frozen=() if hyper.train_act else ("act",))
        if hyper.grad_compression:
            opt_state["error"] = new_err if ok is None else tree_map(
                lambda n, o: torch.where(ok, n, o), new_err,
                opt_state["error"])
        return gnorm, lr, ok

    def train_step(params, opt_state, batch, step):
        if hyper.microbatches > 1:
            (loss, metrics), grads = accumulate(params, batch)
        else:
            (loss, metrics), grads = grads_of(params, batch)
        with torch.no_grad():
            if not hyper.train_act and "act" in grads:
                # frozen approximant params: zero their grads BEFORE the
                # global-norm clip (gnorm then matches a model without them)
                grads = dict(grads,
                             act=tree_map(torch.zeros_like, grads["act"]))
            if hyper.donate:
                gnorm, lr, ok = donated_update(params, opt_state, grads,
                                               loss, step)
                if ok is not None:
                    metrics = dict(metrics, skipped=(~ok).to(torch.int32))
                return params, opt_state, dict(metrics, loss=loss,
                                               gnorm=gnorm, lr=lr)
            grads, gnorm = adamw.clip_by_global_norm(grads,
                                                     hyper.opt.clip_norm)
            if hyper.grad_compression:
                grads, new_err = compress.compress_grads(grads,
                                                         opt_state["error"])
            lr = adamw.cosine_schedule(hyper.opt, step, loss.device)
            inner = {k: opt_state[k] for k in ("m", "v", "count")}
            new_params, new_inner = adamw.adamw_update(grads, inner, params,
                                                       hyper.opt, lr)
            new_state = dict(new_inner)
            if not hyper.train_act and "act" in new_params:
                # AdamW's weight decay would shrink the frozen leaves even
                # at zero grad: restore params and moments as they were
                new_params = dict(new_params, act=params["act"])
                new_state["m"] = dict(new_state["m"],
                                      act=opt_state["m"]["act"])
                new_state["v"] = dict(new_state["v"],
                                      act=opt_state["v"]["act"])
            if hyper.grad_compression:
                new_state["error"] = new_err
            if hyper.skip_nonfinite:
                # a non-finite loss or gradient norm keeps the old params
                # and state, chosen on the device; the driver counts the
                # skips and rolls back if they persist (ft/driver.py)
                ok = torch.isfinite(loss) & torch.isfinite(gnorm)
                sel = lambda new, old: tree_map(
                    lambda n, o: torch.where(ok, n, o), new, old)
                new_params = sel(new_params, params)
                new_state = sel(new_state, opt_state)
                metrics = dict(metrics, skipped=(~ok).to(torch.int32))
        metrics = dict(metrics, loss=loss, gnorm=gnorm, lr=lr)
        return new_params, new_state, metrics

    return train_step


def make_engine(cfg: ModelConfig) -> ActivationEngine | LayerEngines:
    """Public alias: the validated activation engine(s) for a config."""
    return _make_engine(cfg)


def make_prefill_step(cfg: ModelConfig, capacity: int | None = None):
    """Prefill step. If the batch carries a ``lengths`` [B] entry the
    prompts are ragged/right-padded: logits come from each row's last real
    token and the returned cache is per-slot."""
    engine = _make_engine(cfg)

    def prefill_step(params, batch):
        return M.prefill_fn(params, batch, cfg, engine, capacity=capacity)

    return prefill_step


def make_prefill_chunk_step(cfg: ModelConfig, page_size: int):
    """Chunked-admission prefill step (paged serving): resume one slot's
    ragged prefill at offset ``pos``, attending over its previously
    written ring and scattering the chunk's k/v into the slot's pool
    pages in place. (params, batch{tokens [1,S]}, pool_kv, tbl_row [n],
    k_pos_row [W], pos, clen) -> (last-token logits [1, V], new k_pos
    row). The serve engine wraps this in its chunk step
    (serve/engine.py::make_chunk_prefill)."""
    engine = _make_engine(cfg)

    def chunk_step(params, batch, pool_kv, tbl_row, k_pos_row, pos, clen):
        return M.prefill_chunk_fn(params, batch, cfg, engine, pool_kv,
                                  tbl_row, k_pos_row, pos, clen, page_size)

    return chunk_step


def make_serve_step(cfg: ModelConfig):
    engine = _make_engine(cfg)

    def serve_step(params, batch, cache):
        return M.decode_fn(params, batch, cache, cfg, engine)

    return serve_step


# ---------------------------------------------------------------------------
# sharding resolution for the serve engine's tensors
# ---------------------------------------------------------------------------

def axes_shardings(axes_tree, shapes_tree, mesh, rules):
    """``partition.Sharding`` tree from a logical-axes tree and a matching
    tree of shapes (anything with ``.shape``), resolved strictly."""
    return part.tree_shardings(axes_tree, shapes_tree, mesh=mesh,
                               rules=rules)


def serve_shardings(cfg: ModelConfig, slots: int, seq_len: int, mesh,
                    rules: dict | None = None, *,
                    page_size: int | None = None,
                    n_pages: int | None = None):
    """(params, cache, replicated) shardings of the serve engine: the
    parameters by their logical axes, the cache by ``cache_axes
    (per_slot=True)`` or, with ``page_size`` / ``n_pages``, by the paged
    contract's ``paged_cache_axes`` (the pool's page dim host-addressed
    like slots, kv heads sharded as the slot cache's). Everything else
    (token blocks, slot state, page tables) is replicated: host-scheduled
    per-row values, the same on every rank."""
    rules = rules or part.serve_rules()
    pshapes, paxes = M.abstract_params(cfg)
    psharding = axes_shardings(paxes, pshapes, mesh, rules)
    if page_size is not None:
        cspec = M.paged_cache_spec(cfg, slots, n_pages, page_size, seq_len)
        caxes = M.paged_cache_axes(cfg)
    else:
        cspec = M.cache_spec(cfg, slots, seq_len, per_slot=True)
        caxes = M.cache_axes(cfg, per_slot=True)
    csharding = axes_shardings(caxes, cspec, mesh, rules)
    replicated = part.make_sharding((), (), mesh=mesh, rules=rules)
    return psharding, csharding, replicated
