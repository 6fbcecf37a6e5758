"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676].

Implemented: every layer computes attention and a Mamba-1 branch on the
same normalized input; outputs are per-branch RMS-normalized and averaged
(the paper's fusion). Meta-tokens are omitted (frontend concern; see
DESIGN.md §10). Most Hymba layers use SWA — modeled with window 2048,
which is also what makes the long_500k cell feasible for this arch.
"""
from repro_torch.models.config import ModelConfig
from .common import CR_ACT, smoke_of


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab_size=32001,
        parallel_mamba=True, ssm_state=16, d_inner=3200, conv_kernel=4,
        sliding_window=2048,
        norm="rmsnorm", mlp_act="silu", glu=True,
        rope_theta=10_000.0,
        activation=CR_ACT,
    )


def smoke() -> ModelConfig:
    return smoke_of(full(), n_heads=5, n_kv_heads=1)  # odd head count kept
