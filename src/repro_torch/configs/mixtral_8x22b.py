"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, SWA [arXiv:2401.04088; hf].

Assignment specifies SWA (window 4096, Mistral-style); implemented as a
ring-buffer KV cache, which bounds long_500k decode state.
"""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=32768,
        n_experts=8, top_k=2,
        sliding_window=4096,
        norm="rmsnorm", mlp_act="silu", glu=True,
        rope_theta=1_000_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full())
