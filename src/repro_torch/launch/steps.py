"""Step builders (counterpart of ``repro/launch/steps.py``).

  train_step:         fwd + loss + bwd + clip + (optional int8 error-
                      feedback compression) + AdamW update;
  prefill_step:       forward, returns (last logits, filled cache);
  prefill_chunk_step: one chunk of one paged slot's prompt (chunked
                      admission);
  serve_step:         one-token decode against the cache;

the serve engine's shardings on a tensor-parallel mesh
(``serve_shardings``), a train state's on a (data, model) mesh
(``train_shardings``) and a dry-run cell's step and per-rank inputs
(``build_cell``).

The train step is functional (new params and state, the inputs left as
they were) and enqueues its work without waiting for the device: its
metrics are 0-d tensors on the device, and reading them on the host is
the caller's sync. On a mesh (``make_train_step(mesh=)``) it is the
sharded step: each rank holds its blocks of the state
(``train_shardings``), takes its rows of the global batch, gathers the
FSDP leaves at use and reduces the gradients (``parallel/dp.py``), and
every rank gets the global metrics, bit for bit the same.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import spans
from repro_torch.core import approximant
from repro_torch.core.activations import ActivationEngine, LayerEngines
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compress
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import dp
from repro_torch.parallel import partition as part

from . import shapes as shp


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


def make_train_step(cfg: ModelConfig, hyper: TrainHyper = TrainHyper(),
                    mesh=None, rules: dict | None = None,
                    local_batch: bool = False):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: ``batch`` is {"tokens", "labels"} [B, S] on the params'
    device, ``step`` a host int (or a 0-d tensor) that sets the learning
    rate, and the metrics (0-d tensors) are loss, nll, aux, gnorm, lr and,
    under ``skip_nonfinite``, skipped.

    With ``mesh`` (a ([pod,] data, model) DeviceMesh) the step is the
    sharded one, run under ``partition.axis_rules(mesh, rules)``:
    ``params`` and ``opt_state`` are this rank's blocks
    (``train_shardings``), ``batch`` the global batch, of which the rank
    takes its rows over the batch axes (``dp.local_rows``;
    ``local_batch=True``: ``batch`` is those rows already), and the
    metrics are global and the same on every rank.

    Under a profiler the step opens the spans (``repro_torch.spans``)
    ``train.step`` around the whole step, ``train.forward`` (the loss)
    and ``train.backward`` (the gradients; under ``remat="block"`` the
    blocks' recompute too) once a microbatch, ``train.reduce`` (the
    gradient reduction, on a mesh) and ``train.optimizer`` (clip,
    compression, AdamW, the frozen-leaf restore and the non-finite
    select)."""
    engine = _make_engine(cfg)
    rules = rules or part.DEFAULT_RULES
    fsdp = None
    if mesh is not None:
        fsdp = dp.FSDP(mesh, train_shardings(cfg, mesh, rules)[0])
    norm = adamw.global_norm if fsdp is None else fsdp.global_norm
    reduce_max = None if fsdp is None else fsdp.reduce_max

    def grads_of(params, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        with spans.span("train.forward"):
            loss, metrics = M.loss_fn(p, batch, cfg, engine,
                                      remat=hyper.remat, z_loss=hyper.z_loss,
                                      fsdp=fsdp)
        leaves = tree_leaves(p)
        with spans.span("train.backward"):
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
        gnorm = adamw.clip_by_global_norm_(grads, hyper.opt.clip_norm, norm)
        if hyper.grad_compression:
            grads, new_err = compress.compress_grads(
                grads, opt_state["error"], reduce_max)
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
        with spans.span("train.step"):
            if fsdp is None:
                return local_step(params, opt_state, batch, step)
            if fsdp.group is not None and not local_batch:
                batch = dp.local_rows(batch, fsdp.group.rank,
                                      fsdp.group.size, hyper.microbatches)
            with part.axis_rules(mesh, rules):
                return local_step(params, opt_state, batch, step)

    def local_step(params, opt_state, batch, step):
        if hyper.microbatches > 1:
            (loss, metrics), grads = accumulate(params, batch)
        else:
            (loss, metrics), grads = grads_of(params, batch)
        with torch.no_grad():
            if fsdp is not None:
                with spans.span("train.reduce"):
                    grads = fsdp.reduce_grads(grads)
            with spans.span("train.optimizer"):
                if not hyper.train_act and "act" in grads:
                    # frozen approximant params: zero their grads BEFORE
                    # the global-norm clip (gnorm then matches a model
                    # without them)
                    grads = dict(grads, act=tree_map(torch.zeros_like,
                                                     grads["act"]))
                if hyper.donate:
                    gnorm, lr, ok = donated_update(params, opt_state, grads,
                                                   loss, step)
                    if ok is not None:
                        metrics = dict(metrics,
                                       skipped=(~ok).to(torch.int32))
                    return params, opt_state, dict(metrics, loss=loss,
                                                   gnorm=gnorm, lr=lr)
                # rebinding grads frees the unclipped ones (a copy of
                # the params' size) before the update allocates its own
                grads, gnorm = adamw.clip_by_global_norm(
                    grads, hyper.opt.clip_norm, norm)
                if hyper.grad_compression:
                    grads, new_err = compress.compress_grads(
                        grads, opt_state["error"], reduce_max)
                lr = adamw.cosine_schedule(hyper.opt, step, loss.device)
                inner = {k: opt_state[k] for k in ("m", "v", "count")}
                new_params, new_inner = adamw.adamw_update(
                    grads, inner, params, hyper.opt, lr)
                new_state = dict(new_inner)
                if not hyper.train_act and "act" in new_params:
                    # AdamW's weight decay would shrink the frozen leaves
                    # even at zero grad: restore params and moments
                    new_params = dict(new_params, act=params["act"])
                    new_state["m"] = dict(new_state["m"],
                                          act=opt_state["m"]["act"])
                    new_state["v"] = dict(new_state["v"],
                                          act=opt_state["v"]["act"])
                if hyper.grad_compression:
                    new_state["error"] = new_err
                if hyper.skip_nonfinite:
                    # a non-finite loss or gradient norm keeps the old
                    # params and state, chosen on the device; the driver
                    # counts the skips and rolls back if they persist
                    # (ft/driver.py)
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


def train_shardings(cfg: ModelConfig, mesh, rules: dict | None = None,
                    hyper: TrainHyper = TrainHyper()):
    """(params, opt_state) shardings of a train state on a (data, model)
    mesh, the counterpart of ``serve_shardings``: the params by their
    logical axes under ``rules`` (default ``DEFAULT_RULES``: "embed" and,
    where ``data`` divides it, "expert" FSDP over ``data``; "mlp",
    "heads", "kv", "vocab", "dinner" over ``model``), the state by
    ``opt_state_axes`` (``m`` and ``v`` as the params, ``count``
    replicated), with the error buffers as the params under
    ``grad_compression``."""
    rules = rules or part.DEFAULT_RULES
    pshapes, paxes = M.abstract_params(cfg)
    psharding = axes_shardings(paxes, pshapes, mesh, rules)
    oaxes = opt_state_axes(paxes)
    if hyper.grad_compression:
        oaxes["error"] = paxes
    return psharding, axes_shardings(oaxes, _opt_state_spec(pshapes, hyper),
                                     mesh, rules)


def _opt_state_spec(pshapes, hyper: TrainHyper):
    """The optimizer state's shapes (meta tensors) beside the params'."""
    spec = {"m": pshapes, "v": pshapes,
            "count": torch.empty((), dtype=torch.int32, device="meta")}
    if hyper.grad_compression:
        spec["error"] = pshapes
    return spec


def _local_meta(specs, shardings):
    """Meta tensors of each rank's block of ``specs`` (meta tensors) under
    ``shardings``."""
    return tree_map(lambda t, sh: torch.empty(sh.local_shape(t.shape),
                                              dtype=t.dtype, device="meta"),
                    specs, shardings)


def build_cell(cfg: ModelConfig, shape: shp.ShapeCell, mesh, *,
               rules: dict | None = None, hyper: TrainHyper = TrainHyper(),
               serve_dtype: str = "bfloat16"):
    """``(fn, args)`` for one dry-run cell (the counterpart of the
    reference's, which returns a jitted step and ShapeDtypeStructs).

    ``args`` is one rank's inputs as meta tensors, nothing allocated:
    its blocks of the params (in ``serve_dtype`` for prefill and decode),
    of the optimizer state, of the batch (``shapes.input_specs`` /
    ``batch_axes``) and of the cache, under the cell's shardings
    (``rules``, default ``DEFAULT_RULES``). ``mesh`` may be a stand-in
    with ``.shape``. ``fn`` is the cell's step on those inputs; it is
    built at its first call, which needs a real mesh (a DeviceMesh over
    an initialised process group): the train step (``make_train_step``
    on the rank's rows), or the prefill / decode step with the FSDP
    leaves gathered whole over ``data`` first."""
    rules = rules or part.DEFAULT_RULES
    pshapes, paxes = M.abstract_params(cfg)
    psharding = axes_shardings(paxes, pshapes, mesh, rules)
    specs = shp.input_specs(cfg, shape)
    bsharding = axes_shardings(shp.batch_axes(cfg, shape), specs["batch"],
                               mesh, rules)
    batch = _local_meta(specs["batch"], bsharding)

    if shape.kind == "train":
        _, osharding = train_shardings(cfg, mesh, rules, hyper)
        args = (_local_meta(pshapes, psharding),
                _local_meta(_opt_state_spec(pshapes, hyper), osharding), batch,
                torch.empty((), dtype=torch.int32, device="meta"))
        return _built_on_call(lambda: make_train_step(
            cfg, hyper, mesh=mesh, rules=rules, local_batch=True)), args

    sdt = getattr(torch, serve_dtype)
    params = tree_map(lambda t: t.to(sdt) if t.is_floating_point() else t,
                      _local_meta(pshapes, psharding))
    if shape.kind == "prefill":
        return _built_on_call(lambda: _gathered(
            make_prefill_step(cfg, capacity=M.cache_capacity(
                cfg, shape.seq_len)), cfg, mesh, rules)), (params, batch)
    csharding = axes_shardings(M.cache_axes(cfg), specs["cache"], mesh,
                               rules)
    return (_built_on_call(lambda: _gathered(make_serve_step(cfg), cfg,
                                             mesh, rules)),
            (params, batch, _local_meta(specs["cache"], csharding)))


def _built_on_call(build):
    """A function that builds its step (``build()``) at its first call, or
    at ``fn.ready()`` (a cost count builds it first: the shardings' meta
    tensors are no part of the step)."""
    def fn(*args):
        return fn.ready()(*args)

    def ready():
        if fn.step is None:
            fn.step = build()
        return fn.step

    fn.step = None
    fn.ready = ready
    return fn


def _gathered(step, cfg: ModelConfig, mesh, rules):
    """``step(params, *rest)`` on a rank's (data, model) blocks of the
    params: run under ``axis_rules(mesh, rules)`` with the FSDP leaves
    gathered whole over ``data`` first."""
    fsdp = dp.FSDP(mesh, train_shardings(cfg, mesh, rules)[0])

    def run(params, *rest):
        with part.axis_rules(mesh, rules), torch.no_grad():
            return step(fsdp.gather_params(params), *rest)

    return run


class ShardedState:
    """A sharded train state's checkpoints (``ft/driver.py``'s
    ``sharded=``): the one-device layout on disk, the file a single
    device and the reference write. ``whole`` gathers every leaf whole
    (every rank joins; the mesh's first rank keeps the tree), ``local``
    cuts this rank's blocks out of a restored whole tree
    (``model.shard_params``)."""

    def __init__(self, cfg: ModelConfig, mesh, rules: dict | None = None,
                 hyper: TrainHyper = TrainHyper()):
        self.cfg = cfg
        self.mesh = mesh
        self.shardings = train_shardings(cfg, mesh, rules, hyper)[0]
        self.fsdp = dp.FSDP(mesh, self.shardings)
        self.writer = all(mesh.get_local_rank(a) == 0
                          for a in mesh.mesh_dim_names)

    def barrier(self) -> None:
        """Every rank of the mesh has arrived: a barrier along each axis
        in turn (the mesh may be part of the world)."""
        import torch.distributed as dist
        for a in self.mesh.mesh_dim_names:
            dist.barrier(group=self.mesh.get_group(a))

    def whole(self, tree):
        """{"params", "opt_state"} of this rank's blocks -> the whole tree
        on the host (the writer; None on the other ranks)."""
        keep = self.writer
        opt = tree["opt_state"]
        out = {"params": self.fsdp.whole(tree["params"], keep),
               "opt_state": {k: (v.cpu() if k == "count" else
                                 self.fsdp.whole(v, keep))
                             for k, v in opt.items()}}
        return out if keep else None

    def template(self, tree):
        """The whole tree's shapes (meta tensors) of a state laid out like
        ``tree``."""
        full, _ = M.abstract_params(self.cfg)
        return {"params": full,
                "opt_state": {k: (torch.empty((), device="meta")
                                  if k == "count" else full)
                              for k in tree["opt_state"]}}

    def local(self, full, like):
        """A restored whole tree (numpy leaves) -> this rank's blocks, each
        in ``like``'s leaf's dtype and on its device."""
        def cut(t):
            return M.shard_params(t, self.cfg, self.shardings)

        blocks = {"params": cut(full["params"]),
                  "opt_state": {k: (torch.as_tensor(v) if k == "count"
                                    else cut(v))
                                for k, v in full["opt_state"].items()}}
        return tree_map(lambda t, ref: t.to(device=ref.device,
                                            dtype=ref.dtype),
                        blocks, like)
