"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936. GQA + QKV bias [hf:Qwen/Qwen2.5; hf]."""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, vocab_size=151936,
        norm="rmsnorm", qkv_bias=True,
        mlp_act="silu", glu=True,
        rope_theta=1_000_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full(), n_kv_heads=1)  # keep extreme GQA ratio
