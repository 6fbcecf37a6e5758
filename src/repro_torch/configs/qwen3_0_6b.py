"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936. qk_norm, GQA, explicit head_dim=128 [hf:Qwen/Qwen3; hf]."""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab_size=151936,
        norm="rmsnorm", qk_norm=True,
        mlp_act="silu", glu=True,
        rope_theta=1_000_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full())
