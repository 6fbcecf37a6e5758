"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert; early fusion
multimodal [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Early-fusion frontend is a stub (text tokens only here); all layers MoE
per the assignment (real Scout interleaves dense layers — noted in
DESIGN.md §10).
"""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        n_experts=16, top_k=1, shared_expert=True,
        norm="rmsnorm", mlp_act="silu", glu=True,
        rope_theta=500_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full(), top_k=1)
