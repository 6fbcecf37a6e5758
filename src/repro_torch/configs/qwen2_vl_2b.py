"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Vision tower is a stub per the assignment: `input_specs()` provides
precomputed patch embeddings [B, S, d] added onto the token embeddings,
plus 3-component (t/h/w) M-RoPE position ids [B, S, 3].
"""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab_size=151936,
        norm="rmsnorm", qkv_bias=True,
        rope_kind="mrope", mrope_sections=(16, 24, 24),
        patch_embed_input=True,
        mlp_act="silu", glu=True,
        rope_theta=1_000_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full(), mrope_sections=(2, 3, 3))  # head_dim 16 -> halves 8
