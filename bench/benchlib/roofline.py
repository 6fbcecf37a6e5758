"""The benchmark's yardstick: the H100's published peaks, the work of the
program's two hand-written kernels computed from their shapes, and the
model FLOPs behind an MFU. Kept here, apart from the program, so that no
change to the program can move it.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
``model_flops`` and ``param_count`` are copies of the arithmetic of
``repro_torch/analysis/roofline.py::model_flops_for`` and
``repro_torch/models/config.py::ModelConfig.param_count`` /
``active_param_count`` (a test holds them equal), over a configuration
file's ``model`` section.
"""
from __future__ import annotations

import math

PEAK_FLOPS_BF16 = 989e12      # tensor cores, bf16 / f16
PEAK_FLOPS_F32 = 67e12        # CUDA cores, f32 (no TF32)
HBM_BW = 3.35e12              # bytes/s

# f32 operations of one epilogue element: the wiring around the tanh unit
# (silu: the halving, 1 +, the halving, the product), |x|, saturate and
# sign, and the Catmull-Rom block (index split 6, basis 22, 4-tap MAC 7)
WIRING_OPS = {"tanh": 0, "sigmoid": 3, "silu": 4, "gelu_tanh": 8,
              "softplus": 3}
CR_BLOCK_OPS = 6 + 22 + 7


def epilogue_ops(act: str = "silu") -> int:
    return WIRING_OPS[act] + 1 + 3 + CR_BLOCK_OPS


def glu_work(m: int, k: int, n: int, itemsize: int, act: str = "silu",
             params_numel: int = 128):
    """(tensor-core FLOPs, CUDA-core FLOPs, bytes) of one ``glu_2d``
    launch: out[m, n] = act(x[m, k] @ Wg[k, n]) * (x @ Wu): two products,
    the epilogue on every output element; x, both weights and the params
    read once, out written once."""
    return (4 * m * k * n, m * n * epilogue_ops(act),
            (m * k + 2 * k * n + m * n) * itemsize + params_numel * 4)


def elementwise_work(n_elems: int, itemsize: int, act: str = "silu",
                     params_numel: int = 128):
    """(0, CUDA-core FLOPs, bytes) of one ``elementwise_2d`` launch: the
    epilogue on every element, x read and y written once."""
    return (0, n_elems * epilogue_ops(act),
            2 * n_elems * itemsize + params_numel * 4)


def bound_s(tensor_flops: float, vector_flops: float, nbytes: float,
            tensor_peak: float = PEAK_FLOPS_BF16) -> float:
    """The least time the card could take: the largest of the tensor-core
    term, the CUDA-core term and the HBM term (they may overlap, so the
    largest alone is a bound)."""
    return max(tensor_flops / tensor_peak, vector_flops / PEAK_FLOPS_F32,
               nbytes / HBM_BW)


def padded_vocab(model: dict) -> int:
    m = model.get("vocab_pad_multiple", 256)
    return -(-model["vocab_size"] // m) * m


def param_count(model: dict) -> int:
    d = model["d_model"]
    heads, kv = model.get("n_heads", 0), model.get("n_kv_heads", 0)
    hd = model.get("head_dim") or d // max(heads, 1)
    K = model.get("n_codebooks", 1)
    use_mamba = model.get("use_mamba", False)
    parallel_mamba = model.get("parallel_mamba", False)
    n = padded_vocab(model) * d * 2 * K
    per_layer = 0
    if (heads > 0 and not use_mamba) or parallel_mamba:
        per_layer += d * heads * hd + 2 * d * kv * hd + heads * hd * d
    if use_mamba or parallel_mamba:
        di = model.get("d_inner") or 2 * d
        N = model.get("ssm_state", 16)
        dtr = model.get("dt_rank") or math.ceil(d / 16)
        ck = model.get("conv_kernel", 4)
        per_layer += 2 * d * di + di * ck + di * (dtr + 2 * N) + dtr * di \
            + di * N + di + di * d
    f = model.get("d_ff", 0)
    if f > 0:
        ffn = (3 if model.get("glu", True) else 2) * d * f
        e = model.get("n_experts", 0)
        if e > 0:
            per_layer += e * ffn + d * e
            if model.get("shared_expert", False):
                per_layer += ffn
        else:
            per_layer += ffn
    return n + model["n_layers"] * per_layer


def active_param_count(model: dict) -> int:
    e = model.get("n_experts", 0)
    if e == 0:
        return param_count(model)
    d = model["d_model"]
    ffn = (3 if model.get("glu", True) else 2) * d * model["d_ff"]
    dense = param_count(model) - model["n_layers"] * e * ffn
    return dense + model["n_layers"] * model.get("top_k", 2) * ffn


def model_flops(model: dict, tokens: int, kind: str) -> float:
    """6 N D for training, 2 N D forward only; N the active parameters."""
    return (6.0 if kind == "train" else 2.0) * active_param_count(model) \
        * tokens
