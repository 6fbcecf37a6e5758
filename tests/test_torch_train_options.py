"""Port vs reference: the train step's options, on the reference's own
weights (``qwen3-0.6b`` smoke, f32): remat="dots", microbatches=2,
grad_compression, and a non-finite batch that must be skipped with the
params unchanged. Setup, helpers and tolerances are
``test_torch_train.py``'s (see its docstring)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compress as JC  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compress as TC  # noqa: E402
from test_torch_train import (PARAM_OVER_LR, REL_MOMENT, assert_leaves,  # noqa: E402
                              assert_scalars, flat, run_both, setup)

REL_QSTEP = 2 / 127


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_remat_dots_matches_reference():
    """remat="dots" keeps the matmul outputs and reruns the rest in the
    backward (the reference's checkpoint_dots policy)."""
    _, _, jp, tp, jstep, tstep, batch = setup("fused", remat="dots",
                                              train_act=True)
    (jp2, jo2, jm), (tp2, to2, tm) = run_both(jp, tp, jstep, tstep, batch)
    assert_scalars(tm, jm)
    assert_leaves(tp2, jp2, atol=PARAM_OVER_LR * float(jm["lr"]))
    assert_leaves(to2["m"], jo2["m"], rel=REL_MOMENT)
    assert_leaves(to2["v"], jo2["v"], rel=REL_MOMENT)


def test_microbatches_match_reference():
    _, _, jp, tp, jstep, tstep, batch = setup("plain", remat="none",
                                              microbatches=2)
    (jp2, jo2, jm), (tp2, to2, tm) = run_both(jp, tp, jstep, tstep, batch)
    assert_scalars(tm, jm)
    assert_leaves(tp2, jp2, atol=PARAM_OVER_LR * float(jm["lr"]))
    assert_leaves(to2["m"], jo2["m"], rel=REL_MOMENT)
    assert_leaves(to2["v"], jo2["v"], rel=REL_MOMENT)


def test_grad_compression_matches_reference():
    _, _, jp, tp, jstep, tstep, batch = setup("fused", remat="none",
                                              grad_compression=True)
    jo = dict(JA.init_state(jp), error=JC.init_error(jp))
    to = dict(TA.init_state(tp), error=TC.init_error(tp))
    (jp2, jo2, jm), (tp2, to2, tm) = run_both(jp, tp, jstep, tstep, batch,
                                              jo, to)
    assert_scalars(tm, jm)
    assert_leaves(tp2, jp2, atol=PARAM_OVER_LR * float(jm["lr"]))
    # an element on a rounding boundary may land one int8 step apart in
    # the two packages: m and v agree to within that step (1/127 of the
    # leaf's largest value, twice over two steps)
    assert_leaves(to2["m"], jo2["m"], rel=REL_QSTEP)
    assert_leaves(to2["v"], jo2["v"], rel=REL_QSTEP)
    # the error buffers hold the rounding residual, at most half a step:
    # they agree to within one step (twice the larger residual)
    te, je = flat(to2["error"]), flat(jo2["error"])
    for k in je:
        step = 2.02 * max(np.abs(te[k]).max(), np.abs(je[k]).max())
        assert np.abs(te[k] - je[k]).max() <= step, k


def test_nonfinite_batch_is_skipped_with_params_unchanged():
    """An inf embedding row makes the loss non-finite: both packages
    report the skip, and the port's params and state come back bitwise
    as they went in."""
    _, _, jp, tp, jstep, tstep, batch = setup("kernel", remat="none")
    jp = dict(jp, embed=jp["embed"].at[int(batch["tokens"][0, 0])].set(
        jnp.inf))
    tp = dict(tp, embed=tp["embed"].clone())
    tp["embed"][int(batch["tokens"][0, 0])] = float("inf")
    topt = TA.init_state(tp)
    (_, _, jm), (tp2, to2, tm) = run_both(jp, tp, jstep, tstep, batch,
                                          topt=topt, steps=(1,))
    assert int(jm["skipped"]) == int(tm["skipped"]) == 1
    assert not np.isfinite(float(tm["loss"]))
    for k, v in flat(tp).items():
        np.testing.assert_array_equal(flat(tp2)[k], v)
    for k, v in flat(topt).items():
        np.testing.assert_array_equal(flat(to2)[k], v)


@pytest.mark.parametrize("train_act", [False, True])
def test_donated_step_equals_functional_step(train_act, monkeypatch):
    """TrainHyper(donate=True) updates params and state in place with the
    functional step's arithmetic: three steps (the second on a batch with
    an inf embedding row, which both must skip) give bitwise the same
    params, moments, count and metrics, and the donated trees are the
    ones passed in. Leaves are updated in pieces (cut small here, so the
    larger ones split unevenly)."""
    monkeypatch.setattr(TA, "UPDATE_PIECE", 1000)
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM
    cfg = registry.get("qwen3-0.6b", smoke=True)
    cfg = dataclasses.replace(cfg, compute_dtype="float32", n_layers=2)
    pipe = SyntheticPipeline(cfg, DataConfig(seed=1, vocab_size=512), 2, 8,
                             device="cpu")
    opt = TA.AdamWConfig(warmup_steps=1)
    trees = {}
    for donate in (False, True):
        params = TM.materialize_params(cfg, seed=0, device="cpu")
        state = TA.init_state(params)
        step_fn = TS.make_train_step(cfg, TS.TrainHyper(
            opt=opt, remat="none", train_act=train_act, donate=donate))
        metrics = []
        for step in (1, 2, 3):
            batch = pipe(step)
            if step == 2:
                params = dict(params, embed=params["embed"].clone())
                params["embed"][int(batch["tokens"][0, 0])] = float("inf")
            p_in, s_in = params, state
            params, state, m = step_fn(params, state, batch, step)
            assert (params is p_in and state is s_in) == donate
            metrics.append({k: float(v) for k, v in m.items()})
            if step == 2:
                params = dict(params, embed=torch.nan_to_num(
                    params["embed"], posinf=0.0))
        assert [m["skipped"] for m in metrics] == [0, 1, 0]
        trees[donate] = (flat(params), flat(state), metrics)
    (fp, fs, fm), (dp, ds, dm) = trees[False], trees[True]
    np.testing.assert_equal(dm, fm)        # NaN metrics of the skip alike
    for got, want in ((dp, fp), (ds, fs)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
