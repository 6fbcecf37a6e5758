"""Port vs reference: qwen3-0.6b (smoke, f32) run forward and trained
through each ``<scheme>_fixed`` integer datapath, on the reference's
weights carried over by ``params_from_numpy``, and the launchers'
``*_fixed`` flags.

Tolerances (measured on the CPU in brackets). The activation is
quantized to Q2.13, so a gate pre-activation that the two frameworks'
GEMMs round ~3e-6 apart can land on either side of a lattice boundary
and move the activation by one LSB (1.22e-4); the float deployments'
1e-4 on the logits does not hold here.
  * f32 logits: absolute 5e-4, about four Q2.13 LSBs [<= 1.07e-4 on
    logits of magnitude ~4.1];
  * loss and gradient norm of one train step: relative 1e-5
    [<= 1.5e-7 and <= 6.3e-7];
  * params after that step: absolute 0.05 x lr, as in
    ``test_torch_train.py`` [the gradients of the loss, compared once
    per leaf relative to its largest |grad|, were <= 2.0e-5].
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.common import act_impl_of as j_act_impl_of  # noqa: E402
from repro.configs.common import fused_of as j_fused_of  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticPipeline as JPipeline  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import mlp_fusable  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from test_torch_train import PARAM_OVER_LR, assert_leaves  # noqa: E402

IMPLS = ("cr_fixed", "pwl_fixed", "poly_fixed", "rational_fixed")
LOGITS_ATOL, REL_SCALAR = 5e-4, 1e-5
LR_PEAK, WARMUP = 1e-2, 2


def configs(impl):
    jc = JR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    tc = TR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    return j_act_impl_of(jc, impl), act_impl_of(tc, impl)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_train_step_match_reference(impl):
    jc, tc = configs(impl)
    jp, _ = JM.materialize_params(jc, seed=0)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    assert list(tp["act"]) == [f"{impl}-d32"]
    engine = TS.make_engine(tc)
    assert engine.cfg.impl == impl and engine.act_impl is None
    assert not mlp_fusable(tc, engine)

    toks = np.random.RandomState(0).randint(0, 512, (2, 21)).astype(np.int32)
    jl = JM.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jc,
                       JS.make_engine(jc))
    tl = TM.forward_fn(tp, {"tokens": torch.from_numpy(toks)}, tc, engine)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGITS_ATOL)

    batch = jax.tree.map(np.asarray, JPipeline(
        jc, JDataConfig(seed=1, vocab_size=512), 4, 16)(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    # one update at step 1 (the warmup lr is 0 at step 0), act trainable
    jh = JS.TrainHyper(opt=JA.AdamWConfig(lr_peak=LR_PEAK,
                                          warmup_steps=WARMUP),
                       remat="none", train_act=True)
    th = TS.TrainHyper(opt=TA.AdamWConfig(lr_peak=LR_PEAK,
                                          warmup_steps=WARMUP),
                       remat="none", train_act=True)
    jp2, _, jm = jax.jit(JS.make_train_step(jc, jh))(
        jp, JA.init_state(jp), jb, jnp.int32(1))
    tp2, _, tm = TS.make_train_step(tc, th)(tp, TA.init_state(tp), tb, 1)
    assert int(tm["skipped"]) == int(jm["skipped"]) == 0
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=REL_SCALAR, err_msg=k)
    assert_leaves(tp2, jp2, atol=PARAM_OVER_LR * float(jm["lr"]))
    assert not torch.equal(tp2["act"][f"{impl}-d32"],
                           tp["act"][f"{impl}-d32"])


def test_fuse_mlp_contract_under_fixed_impls():
    """``fused_of`` leaves a ``*_fixed`` config unfused, as the
    reference's does, and an explicit ``fuse_mlp`` fails the step build
    (``mlp_fusable`` is false: the integer datapath has no kernel)."""
    import dataclasses

    for impl in IMPLS:
        jc, tc = configs(impl)
        assert fused_of(tc) == tc and j_fused_of(jc) == jc
        with pytest.raises(ValueError, match="fuse_mlp=True requires"):
            TS.make_train_step(dataclasses.replace(tc, fuse_mlp=True))


def test_launchers_take_the_fixed_flags(tmp_path):
    """``--activation pwl_fixed`` serves and ``--act-impl rational_fixed``
    trains, on the CPU when asked (``--activation cr_fixed`` training:
    ``tests/test_torch_ft.py``)."""
    stats = serve_mod.main(["--smoke", "--device", "cpu", "--activation",
                            "pwl_fixed", "--batch", "2", "--prompt-len",
                            "8", "--gen", "3", "--json",
                            str(tmp_path / "s.json")])
    assert stats.n_prompts == 2 and stats.generated == 3
    assert json.loads((tmp_path / "s.json").read_text())["generated"] == 3
    summary = train_mod.main(["--smoke", "--device", "cpu", "--steps", "1",
                              "--act-impl", "rational_fixed", "--ckpt-dir",
                              str(tmp_path / "ck"), "--log-every", "0"])
    assert summary["skipped"] == 0 and np.isfinite(summary["loss_first"])
