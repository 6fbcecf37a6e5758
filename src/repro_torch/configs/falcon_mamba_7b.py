"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free d_ff=0 vocab=65024,
ssm_state=16 — Mamba-1 architecture [arXiv:2410.05355; unverified].

Every layer is a Mamba-1 block (in_proj -> depthwise causal conv ->
selective scan -> gate -> out_proj); no attention, no FFN. Decode carries
(conv ring, ssm state) instead of a KV cache, which is what makes the
long_500k cell run at O(1) state.
"""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=65024,
        use_mamba=True, ssm_state=16, d_inner=8192, conv_kernel=4, dt_rank=256,
        norm="rmsnorm", rope_kind="none",
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full())
