"""Shared helpers for architecture configs (counterpart of
``repro/configs/common.py``)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.activations import ActivationConfig
from repro_torch.models.config import ModelConfig

# Framework default: the paper's flagship CR-spline engine (depth 32).
CR_ACT = ActivationConfig(impl="cr", depth=32, x_max=4.0)

# Hardware-deployment engine: every nonlinearity is ONE launch of the
# elementwise epilogue kernel (kernels/epilogue.py).
CR_ACT_KERNEL = ActivationConfig(impl="cr", depth=32, x_max=4.0,
                                 use_kernel=True)


def fused_of(cfg: ModelConfig) -> ModelConfig:
    """The fully-fused deployment of an arch: GLU FFNs run through the
    fused matmul+epilogue kernel and the engine's element-wise
    nonlinearities through single-launch epilogue kernels. Identity on
    configs with nothing to fuse. The scheme stays whatever the config's
    ``act_impl``/engine selects (paper CR by default)."""
    from repro_torch.core.activations import scheme_of
    from repro_torch.kernels.epilogue import EPILOGUES
    if not (cfg.glu and cfg.has_ffn and cfg.mlp_act in EPILOGUES):
        return cfg
    impl = cfg.act_impl or (
        cfg.activation.impl if scheme_of(cfg.activation.impl) else "cr")
    if scheme_of(impl) is None:     # non-approximant override: honestly
        return cfg                  # leave the config unfused
    return dataclasses.replace(
        cfg, fuse_mlp=True,
        activation=dataclasses.replace(cfg.activation, impl=impl,
                                       use_kernel=True))


def act_impl_of(cfg: ModelConfig, scheme: str,
                use_kernel: bool | None = None) -> ModelConfig:
    """Run ``cfg`` under a different approximant scheme (the ``--act-impl``
    flag): sets ``act_impl`` (validated at step-build time in
    launch/steps.py); ``use_kernel=True`` additionally forces every
    nonlinearity through the scheme's epilogue kernel."""
    act = cfg.activation
    if use_kernel is not None:
        act = dataclasses.replace(act, use_kernel=use_kernel)
    return dataclasses.replace(cfg, act_impl=scheme, activation=act)


def act_layers_of(cfg: ModelConfig, assignment,
                  use_kernel: bool | None = None) -> ModelConfig:
    """Run ``cfg`` under a per-layer approximant assignment (the
    autotuner's output): one entry per layer, an ActivationConfig, a
    ``tag()`` string (``pwl-d16``) or a bare impl name. Clears
    ``act_impl`` (the uniform shorthand; the two are mutually exclusive)
    and validates eagerly, so a malformed assignment fails here and not
    at step-build time."""
    act = cfg.activation
    if use_kernel is not None:
        act = dataclasses.replace(act, use_kernel=use_kernel)
    out = dataclasses.replace(cfg, act_impl="",
                              act_layers=tuple(assignment), activation=act)
    out.layer_activation_configs()
    return out


def smoke_of(cfg: ModelConfig, **extra) -> ModelConfig:
    """Reduced same-family config: tiny dims, few layers, small vocab."""
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_multiple=64,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2),
        moe_impl="ragged" if cfg.n_experts else cfg.moe_impl,
        d_inner=128 if (cfg.use_mamba or cfg.parallel_mamba) else 0,
        ssm_state=8,
        dt_rank=8,
        sliding_window=32 if cfg.sliding_window else None,
        q_chunk=16,
        kv_chunk=16,
        name=cfg.name + "-smoke",
    )
    base.update(extra)
    return dataclasses.replace(cfg, **base)
