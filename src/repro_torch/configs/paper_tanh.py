"""paper-tanh: a ~100M-parameter dense LM whose FFN nonlinearity is tanh
itself — the closest-to-paper deployment (every FFN activation runs the
CR-spline tanh unit directly). Used by the end-to-end training example
and the accuracy-vs-backend ablations.
"""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="paper-tanh", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=32768,
        norm="rmsnorm", mlp_act="tanh", glu=True,
        rope_theta=10_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full())
