"""Model configuration. One instance fully describes an architecture;
`repro_torch/configs/<arch>.py` files build these (counterpart of
``repro/models/config.py``, every field unchanged)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.activations import ActivationConfig


def pad_to_multiple(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | vlm | audio

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4                # 0 for attn-free (ssm)
    n_kv_heads: int = 4
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 1024                # 0 for attn-free mamba (no FFN block)
    vocab_size: int = 1024
    vocab_pad_multiple: int = 256   # padded for TP (Megatron-style)

    # norms / attention details
    norm: str = "rmsnorm"           # rmsnorm | layernorm_np (non-parametric)
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen2.5 / qwen2-vl
    rope_theta: float = 10000.0
    rope_kind: str = "rope"         # rope | mrope | none
    mrope_sections: tuple = (16, 24, 24)   # qwen2-vl (halves of head_dim)
    sliding_window: Optional[int] = None   # mixtral 4096, hymba 2048
    logit_softcap: Optional[float] = None  # tanh softcap (uses the CR engine)

    # FFN
    mlp_act: str = "silu"           # silu (SwiGLU) | gelu_tanh (plain MLP w/ GLU)
    glu: bool = True                # gated (SwiGLU/GeGLU) vs plain 2-layer MLP
    fuse_mlp: bool = False          # route GLU FFNs (incl. the MoE shared
                                    # expert) through the fused
                                    # matmul+spline-epilogue kernel; needs
                                    # glu=True, a CR activation engine, and
                                    # mlp_act in kernels.epilogue.EPILOGUES

    # MoE
    n_experts: int = 0
    top_k: int = 2
    shared_expert: bool = False     # llama4
    router_aux_weight: float = 0.01
    moe_impl: str = "gshard"        # gshard (grouped one-hot einsum dispatch,
                                    # shards cleanly under pjit) | ragged
                                    # (dropless sort + ragged_dot; exact but
                                    # unshardable dispatch -- single-host only)
    capacity_factor: float = 1.25   # gshard per-expert slot headroom
    moe_group_size: int = 4096      # gshard dispatch group length: capacity
                                    # C = ceil(group*cf/E) must not scale
                                    # with S or dispatch flops rival attention

    # SSM (mamba-1)
    use_mamba: bool = False         # falcon-mamba: every layer is mamba
    parallel_mamba: bool = False    # hymba: attn and mamba heads in parallel
    ssm_state: int = 16
    d_inner: int = 0                # 0 -> 2 * d_model
    conv_kernel: int = 4
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)

    # multi-codebook audio heads (musicgen)
    n_codebooks: int = 1

    # VLM stub (qwen2-vl): batch supplies precomputed patch embeddings
    patch_embed_input: bool = False

    # activation engine (the paper's technique)
    activation: ActivationConfig = dataclasses.field(default_factory=ActivationConfig)
    act_impl: str = ""              # approximant scheme override: when set
                                    # ("cr_spline"|"pwl"|"poly"|"rational"|
                                    # any registered scheme, or an engine
                                    # impl like "exact"/"cr_fixed"), the
                                    # step builders run the engine with
                                    # activation.impl replaced by it —
                                    # validated in launch/steps.py so train
                                    # AND serve run the scheme end-to-end
    act_layers: tuple = ()          # per-layer approximant assignment (the
                                    # autotuner's output): one entry per
                                    # layer, each an ActivationConfig, an
                                    # ActivationConfig.tag() string, or a
                                    # bare impl name. Mutually exclusive
                                    # with act_impl (the uniform shorthand)

    # precision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # attention chunking (flash-style lax.scan blocks)
    q_chunk: int = 2048
    kv_chunk: int = 1024

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0 and not self.use_mamba

    @property
    def has_ffn(self) -> bool:
        return self.d_ff > 0

    def layer_activation_configs(self) -> tuple[ActivationConfig, ...]:
        """The resolved per-layer ActivationConfig assignment (length
        ``n_layers``). ``act_layers`` entries may be ActivationConfig
        instances, ``tag()`` strings (impl-d{depth}[-g{deg}][-q{i}.{f}]),
        or bare impl names (which keep this model's depth/x_max/etc.).
        Without ``act_layers`` this is the uniform assignment the stack
        always ran: ``activation`` with the ``act_impl`` override."""
        base = self.activation
        if not self.act_layers:
            if self.act_impl:
                base = dataclasses.replace(base, impl=self.act_impl)
            return (base,) * self.n_layers
        if self.act_impl:
            raise ValueError(
                f"{self.name}: act_layers and act_impl are mutually "
                f"exclusive — act_impl is the uniform shorthand")
        if len(self.act_layers) != self.n_layers:
            raise ValueError(
                f"{self.name}: act_layers has {len(self.act_layers)} "
                f"entries for n_layers={self.n_layers}")
        out = []
        for e in self.act_layers:
            if isinstance(e, ActivationConfig):
                out.append(e)
            elif isinstance(e, str) and "-" in e:
                out.append(ActivationConfig.from_tag(
                    e, x_max=base.x_max, use_kernel=base.use_kernel))
            elif isinstance(e, str):
                out.append(dataclasses.replace(base, impl=e))
            else:
                raise ValueError(
                    f"{self.name}: bad act_layers entry {e!r} (want "
                    f"ActivationConfig, tag string, or impl name)")
        return tuple(out)

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.head_dim_
        n = self.padded_vocab * d * 2 * self.n_codebooks  # embed + head
        per_layer = 0
        if self.has_attention or self.parallel_mamba:
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        if self.use_mamba or self.parallel_mamba:
            di, N, dtr = self.d_inner_, self.ssm_state, self.dt_rank_
            per_layer += 2 * d * di + di * self.conv_kernel \
                + di * (dtr + 2 * N) + dtr * di + di * N + di + di * d
        if self.has_ffn:
            ffn = (3 if self.glu else 2) * d * self.d_ff
            if self.n_experts > 0:
                per_layer += self.n_experts * ffn + d * self.n_experts
                if self.shared_expert:
                    per_layer += ffn
            else:
                per_layer += ffn
        return n + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        ffn = (3 if self.glu else 2) * d * self.d_ff
        dense_share = self.param_count() - self.n_layers * self.n_experts * ffn
        return dense_share + self.n_layers * self.top_k * ffn
