"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
llama-arch GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab_size=64000,
        norm="rmsnorm", mlp_act="silu", glu=True,
        rope_theta=5_000_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full())
