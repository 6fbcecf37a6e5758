"""The weights of a run, made on the device from the seed: one generator
call a parameter leaf (a leaf holds every layer, stacked), each leaf from
its own seed, so the reference can make any leaf again, bit for bit,
without the others. The leaves and their shapes are the program's
parameter tree; the values are the benchmark's own: normal draws at
1 / sqrt(fan-in) (the embedding at 0.02), norm scales at one, biases at
zero, and the approximant's tanh table from the benchmark's frozen copy.

``serve`` weights are in the type they are served in: the products'
matrices and the embedding in the compute type, the router, the norm
scales and the head in f32. ``train`` weights are the f32 masters."""
from __future__ import annotations

import math

import torch

from benchref import crspline

# the leaves a serving deployment holds in the compute type
COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv",
                            "w_gate", "w_up", "w_down", "embed", "in_proj",
                            "conv_w", "conv_b", "x_proj", "dt_proj_w",
                            "out_proj"})
ONES = frozenset({"scale", "q_norm", "k_norm", "D"})
ZEROS = frozenset({"bq", "bk", "bv", "conv_b"})

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit seed for leaf ``path`` under run seed ``seed``."""
    z = _mix(seed & _MASK)
    for ch in path.encode():
        z = _mix(z ^ ch)
    return z >> 1


def std_of(path: str, model: dict) -> float:
    name = path.split(".")[-1]
    d, f = model["d_model"], model["d_ff"]
    if name == "embed":
        return 0.02
    if name == "wo":
        return 1.0 / math.sqrt(model["n_heads"] * model["head_dim"])
    if name == "w_down":
        return 1.0 / math.sqrt(f)
    return 1.0 / math.sqrt(d)


def shapes(cfg) -> dict:
    """The program's parameter tree as {path: shape}."""
    from repro_torch.models import model as M

    def walk(t, prefix=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(walk(v, f"{prefix}{k}."))
            return out
        return {prefix[:-1]: tuple(t.shape)}

    return walk(M.abstract_params(cfg)[0])


def make_leaf(path: str, shape: tuple, model: dict, seed: int, dtype,
              device) -> torch.Tensor:
    name = path.split(".")[-1]
    if path.startswith("act."):
        act = model.get("activation", {})
        win = crspline.tanh_windows(act.get("x_max", 4.0), act.get("depth", 32))
        if tuple(win.shape) != tuple(shape):
            raise ValueError(f"{path}: table {win.shape} for shape {shape}")
        return torch.as_tensor(win, device=device)
    if name in ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, std_of(path, model), generator=gen)


def make(cfg, model: dict, seed: int, use: str, device) -> dict:
    """The parameter tree for ``use`` ("serve" or "train")."""
    cdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        model.get("compute_dtype", "bfloat16")]
    tree: dict = {}
    for path, shape in shapes(cfg).items():
        name = path.split(".")[-1]
        dtype = cdt if use == "serve" and name in COMPUTE_LEAVES \
            else torch.float32
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = make_leaf(path, shape, model, seed, dtype, device)
    _empty_dicts(tree, cfg)
    return tree


def _empty_dicts(tree: dict, cfg) -> None:
    """Keep the program's empty subtrees (a norm without parameters)."""
    from repro_torch.models import model as M

    def walk(t, node):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, node.setdefault(k, {}))

    walk(M.abstract_params(cfg)[0], tree)
