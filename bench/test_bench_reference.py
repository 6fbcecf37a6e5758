"""The benchmark's plain reference agrees with the program's CPU path at
the smoke sizes, both in f32: the frozen CR unit bit for bit, the
forward's logits, and the training loss and its gradients."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_testutil import smoke_cell
from benchlib import weights
from benchref import crspline, lm

HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_frozen_cr_unit_is_the_programs_bit_for_bit():
    from repro_torch.core.activations import tanh_table
    from repro_torch.kernels import epilogue as epi
    win = crspline.tanh_windows(4.0, 32)
    assert np.array_equal(win, tanh_table(4.0, 32).windows.astype(np.float32))
    x = torch.linspace(-6.0, 6.0, 20001, dtype=torch.float32)
    spec = epi._spec_for_epilogue("silu", "cr_spline", 4.0, 32)
    prog = epi.make_epilogue("silu", spec, lookup="take")(x, torch.as_tensor(win))
    assert torch.equal(crspline.silu(x, torch.as_tensor(win)), prog)


def _f32_setup(workload):
    cell = smoke_cell(workload)
    from benchlib.spec import program_config
    cfg = dataclasses.replace(program_config(cell.config), compute_dtype="float32")
    model = dict(cell.model, compute_dtype="float32")
    params = weights.make(cfg, model, 12345, "train", torch.device("cpu"))
    return cfg, model, params


def _ref_logits(params, tokens, arch):
    win = lm.windows_on("cpu", arch)
    pos = torch.arange(tokens.shape[1])
    x = params["embed"][tokens.long()].float()
    pr = lm.Precision("f32")
    for i in range(arch.n_layers):
        x, _ = lm.block(lm.layer(params["blocks"], i), x, pos, arch, pr, win)
    return lm.norm(x, params.get("ln_f", {}), arch) @ params["lm_head"]


@pytest.mark.parametrize("workload", ["olmo-1b.train", "mixtral-8x22b-pp8.chat"])
def test_forward_logits_agree(workload):
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    cfg, model, params = _f32_setup(workload)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, model["vocab_size"], size=(2, 40)), dtype=torch.int32)
    prog = M.forward_fn(params, {"tokens": tokens}, cfg, steps.make_engine(cfg))
    ref = _ref_logits(params, tokens, lm.Arch.of(model))
    assert prog.shape == ref.shape
    assert (prog - ref).abs().max() < 1e-4 * ref.abs().max()


def _dicts(tree):
    """A copy of the tree's dicts over the same tensors."""
    return {k: _dicts(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree


def test_training_loss_and_gradients_agree():
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    cfg, model, params = _f32_setup("olmo-1b.train")
    arch = lm.Arch.of(model)
    rng = np.random.default_rng(1)
    tok = torch.as_tensor(rng.integers(0, model["vocab_size"], (2, 32)),
                          dtype=torch.int32)
    lab = torch.as_tensor(rng.integers(0, model["vocab_size"], (2, 32)),
                          dtype=torch.int32)
    leaves = [(n, t) for n, t in lm.leaves(params) if not n.startswith("act.")]
    prog_p = _dicts(params)
    req = {n: t.clone().requires_grad_() for n, t in leaves}
    for n, t in req.items():
        lm._set(prog_p, n, t)
    total, _ = M.loss_fn(prog_p, {"tokens": tok, "labels": lab}, cfg,
                         steps.make_engine(cfg), remat="none")
    g_prog = torch.autograd.grad(total, list(req.values()))
    ref_p = _dicts(params)
    req2 = {n: t.clone().requires_grad_() for n, t in leaves}
    for n, t in req2.items():
        lm._set(ref_p, n, t)
    ref_total, _ = lm.loss(ref_p, tok, lab, arch, lm.Precision("f32"),
                           lm.windows_on("cpu", arch))
    g_ref = torch.autograd.grad(ref_total, list(req2.values()))
    assert float(total) == pytest.approx(float(ref_total), rel=1e-5)
    for (n, _), a, b in zip(leaves, g_prog, g_ref):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-9, n
