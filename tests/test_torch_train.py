"""Port vs reference: the train step on the reference's own weights.

``qwen3-0.6b`` smoke at f32 compute. The reference's params (jax.random
init) cross over as numpy through ``params_from_numpy``, and its
pipeline's batches as numpy; then one ``make_train_step`` of each package
runs steps 1 and 2 (at step 0 the warmup learning rate is 0, and an
update there proves nothing) from a zero optimizer state. Cases here: the
plain, fused and kernelized deployments, remat none and block, train_act
on and off; ``test_torch_train_options.py`` adds remat="dots",
microbatches=2, grad_compression and a non-finite batch that must be
skipped, with these helpers and tolerances.

Tolerances (measured on the CPU in brackets):
  * loss, nll, gnorm: relative 1e-5 [<= 6e-7];
  * grads (``loss_fn`` differentiated once, at the start): each leaf
    within 2e-5 of the reference relative to its largest |grad| [<= 3e-6];
  * m and v: each leaf relative 2e-4 to its largest |value| [<= 4.1e-5
    after step 2];
  * params: absolute 0.05 x lr [<= 0.017 x lr]. Adam's first updates are
    about lr * sign(g): where |g| is near eps (1e-8) a difference of
    ~1e-9 in g, far below f32's reach on the larger grads it sums with,
    moves the update by a few percent of lr;
  * under grad_compression, m and v relative 2/127 [<= 0.0046]: an
    element on an int8 rounding boundary lands one step apart.
With ``train_act`` off the ``act`` params and moments must come back
bitwise unchanged.
"""
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
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

LR_PEAK, WARMUP = 1e-2, 2
REL_SCALAR, REL_GRAD, REL_MOMENT, PARAM_OVER_LR = 1e-5, 2e-5, 2e-4, 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deployment(dep):
    jc = JR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    tc = TR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    if dep == "fused":
        return j_fused_of(jc), fused_of(tc)
    if dep == "kernel":
        return (j_act_impl_of(jc, "cr_spline", use_kernel=True),
                act_impl_of(tc, "cr_spline", use_kernel=True))
    return jc, tc


def setup(dep, **hyper):
    """(reference config, port config, reference params, port params,
    reference step, port step, batch as numpy) of one deployment."""
    jc, tc = deployment(dep)
    jp, _ = JM.materialize_params(jc, seed=0)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jh = JS.TrainHyper(opt=JA.AdamWConfig(lr_peak=LR_PEAK,
                                          warmup_steps=WARMUP), **hyper)
    th = TS.TrainHyper(opt=TA.AdamWConfig(lr_peak=LR_PEAK,
                                          warmup_steps=WARMUP), **hyper)
    batch = jax.tree.map(np.asarray,
                         JPipeline(jc, JDataConfig(seed=1, vocab_size=512),
                                   4, 16)(0))
    return (jc, tc, jp, tp, jax.jit(JS.make_train_step(jc, jh)),
            TS.make_train_step(tc, th), batch)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def assert_leaves(got, ref, rel=None, atol=None):
    g, r = flat(got), flat(ref)
    assert set(g) == set(r), set(g) ^ set(r)
    for k in r:
        tol = atol if atol is not None else rel * max(
            float(np.abs(r[k]).max()), 1e-30)
        err = float(np.abs(g[k].astype(np.float64) - r[k]).max())
        assert err <= tol, (k, err, tol)


def assert_scalars(tm, jm):
    assert set(tm) == set(jm), (set(tm), set(jm))
    for k in ("loss", "nll", "gnorm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=REL_SCALAR, err_msg=k)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    assert int(tm["skipped"]) == int(jm["skipped"]) == 0


def port_grads(tp, tc, batch, remat):
    p = tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss, _ = TM.loss_fn(p, batch, tc, TS.make_engine(tc), remat=remat)
    leaves = tree_leaves(p)
    got = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss, tree_map(lambda t: got[id(t)], p)


def run_both(jp, tp, jstep, tstep, batch, jopt=None, topt=None,
             steps=(1, 2)):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    jo = JA.init_state(jp) if jopt is None else jopt
    to = TA.init_state(tp) if topt is None else topt
    for s in steps:
        jp, jo, jm = jstep(jp, jo, jb, jnp.int32(s))
        tp, to, tm = tstep(tp, to, tb, s)
    return (jp, jo, jm), (tp, to, tm)


@pytest.mark.parametrize("dep,remat,train_act", [
    ("plain", "none", False), ("plain", "block", True),
    ("fused", "none", True), ("fused", "block", False),
    ("kernel", "none", False), ("kernel", "block", True)])
def test_train_step_matches_reference(dep, remat, train_act):
    jc, tc, jp, tp, jstep, tstep, batch = setup(dep, remat=remat,
                                                train_act=train_act)
    # the gradients of the loss, once
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jb, jc, JS.make_engine(jc),
                             remat=remat)[0]))(jp)
    tloss, tgrads = port_grads(tp, tc, {k: torch.tensor(v)
                                        for k, v in batch.items()}, remat)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=REL_SCALAR)
    assert_leaves(tgrads, jgrads, rel=REL_GRAD)

    tp_in = tree_map(torch.clone, tp)
    (jp2, jo2, jm), (tp2, to2, tm) = run_both(jp, tp, jstep, tstep, batch)
    assert_scalars(tm, jm)
    lr = float(jm["lr"])
    assert_leaves(tp2, jp2, atol=PARAM_OVER_LR * lr)
    assert_leaves(to2["m"], jo2["m"], rel=REL_MOMENT)
    assert_leaves(to2["v"], jo2["v"], rel=REL_MOMENT)
    assert int(to2["count"]) == int(jo2["count"]) == 2
    # the inputs are left as they were (the step is functional)
    for k, v in flat(tp).items():
        np.testing.assert_array_equal(v, flat(tp_in)[k])
    act_tag = next(iter(tp["act"]))
    if train_act:
        assert not torch.equal(tp2["act"][act_tag], tp["act"][act_tag])
    else:
        assert torch.equal(tp2["act"][act_tag], tp["act"][act_tag])
        assert not bool(to2["m"]["act"][act_tag].any())
        assert not bool(to2["v"]["act"][act_tag].any())
