"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab_size=50304,
        norm="layernorm_np",          # OLMo: no scale/bias in LN
        mlp_act="silu", glu=True,
        rope_theta=10_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full(), n_kv_heads=4)  # keep MHA (kv == heads)
