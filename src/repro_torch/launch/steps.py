"""Step builders (counterpart of ``repro/launch/steps.py``, serving half).

  prefill_step:       forward, returns (last logits, filled cache);
  prefill_chunk_step: one chunk of one paged slot's prompt (chunked
                      admission);
  serve_step:         one-token decode against the cache.

The train step (``TrainHyper`` / ``make_train_step``) arrives with the
training slice (ROADMAP.md, Queue A item 7).
"""
from __future__ import annotations

from repro_torch.core import approximant
from repro_torch.core.activations import ActivationEngine
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _make_engine(cfg: ModelConfig) -> ActivationEngine:
    """Engine for a step function, with the config contracts enforced at
    build time: a bogus ``act_impl`` fails the build with the registered-
    scheme list, and a config that asks for ``fuse_mlp`` but cannot get
    it fails instead of silently running unfused."""
    try:
        layer_cfgs = cfg.layer_activation_configs()
        if len(set(layer_cfgs)) != 1:
            raise NotImplementedError(
                f"{cfg.name}: per-layer act_layers assignments are not "
                f"ported yet (ROADMAP.md, Queue A item 9)")
        engine = ActivationEngine(layer_cfgs[0])
        if cfg.has_ffn and cfg.mlp_act == "softplus" and engine.act_impl:
            # the softplus epilogue reads the scheme's residual params; a
            # scheme with no residual build (rational) fails the step build
            c = engine.cfg
            approximant.params_for(approximant.spec_for(
                engine.act_impl, "softplus", x_max=c.x_max, depth=c.depth,
                degree=c.degree), "softplus_res")
    except ValueError as e:
        raise ValueError(f"{cfg.name}: invalid activation config "
                         f"(act_impl={cfg.act_impl!r}, "
                         f"act_layers={cfg.act_layers!r}): {e}") from e
    if cfg.fuse_mlp:
        from repro_torch.models.layers import mlp_fusable
        if not mlp_fusable(cfg, engine):
            raise ValueError(
                f"{cfg.name}: fuse_mlp=True requires glu=True, mlp_act "
                f"in kernels.epilogue.EPILOGUES and an approximant-"
                f"scheme activation engine (got glu={cfg.glu}, "
                f"mlp_act={cfg.mlp_act!r}, impl={engine.cfg.impl!r})")
    return engine


def make_engine(cfg: ModelConfig) -> ActivationEngine:
    """Public alias: the validated activation engine for a config."""
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
