"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

EnCodec frontend is a stub per the assignment: the backbone consumes
4 parallel codebook token streams [B, S, 4] (embeddings summed) and
emits 4 codebook heads. Delay-pattern scheduling and the T5 text
cross-attention conditioning are frontend concerns, omitted (DESIGN §10).
Plain (non-gated) GELU FFN, as in the original transformer decoder.
"""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=2048, n_codebooks=4,
        norm="layernorm_np",
        mlp_act="gelu_tanh", glu=False,
        rope_theta=10_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full(), n_kv_heads=4)  # keep MHA
