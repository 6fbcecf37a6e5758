"""Port vs reference: the MoE family (mixtral-8x22b: top-2, 8 experts,
sliding window; llama4-scout-17b-a16e: top-1, 16 experts, a shared
expert).

The expert layer alone (``apply_moe_gshard`` / ``apply_moe_ragged``) on
the reference's own params and input: output within 1e-5 and aux within
1e-6 relative at f32, and at capacity factor 1.25 the same tokens
dropped. The port's own counterparts of ``tests/test_moe.py``'s four
properties. Through the model: ``loss_fn``'s total and aux and the
gradients of the router, the experts and the shared expert against
``jax.grad`` of the reference (1e-4 relative); greedy tokens of the
port's ServeEngine (paged, its default) identical to the reference's;
the five full configs' parameter counts equal to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.core.activations import ActivationEngine as JEngine  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel.partition import unbox_tree  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.core.activations import ActivationEngine  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402

MOE = ("mixtral-8x22b", "llama4-scout-17b-a16e")
IMPLS = ("gshard", "ragged")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    over = dict(dict(compute_dtype="float32"), **over)
    return JR.get(arch, smoke=True, **over), TR.get(arch, smoke=True, **over)


@pytest.fixture(scope="module", params=MOE)
def layer_setup(request):
    """One MoE layer's reference params (jax.random) and an input
    [2, 16, d], both as numpy, plus the reference and port configs."""
    jc, tc = _cfgs(request.param)
    jp, _ = unbox_tree(JL.init_moe(jax.random.key(0), jc))
    x = np.random.RandomState(1).randn(2, 16, jc.d_model).astype(
        np.float32) * 0.5
    return jc, tc, jax.tree.map(np.asarray, jp), x


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _run(jc, tc, jp, x, fn):
    yj, aj = getattr(JL, fn)(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             jc, JEngine(jc.activation))
    yt, at = getattr(TL, fn)(_to_torch(jp), torch.tensor(x), tc,
                             ActivationEngine(tc.activation))
    return np.asarray(yj), float(aj), yt.numpy(), float(at)


@pytest.mark.parametrize("cf", [1.25, "dropless"])
@pytest.mark.parametrize("fn", ["apply_moe_gshard", "apply_moe_ragged"])
def test_moe_layer_matches_reference(layer_setup, fn, cf):
    jc, tc, jp, x = layer_setup
    if cf == "dropless":
        cf = float(jc.n_experts)
    jc = dataclasses.replace(jc, capacity_factor=cf)
    tc = dataclasses.replace(tc, capacity_factor=cf)
    yj, aj, yt, at = _run(jc, tc, jp, x, fn)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
    assert at == pytest.approx(aj, rel=1e-6)


def test_gshard_drops_the_reference_tokens(layer_setup):
    """At cf = 1.25 with a random router some tokens lose an expert slot:
    a token's gshard output differs from the dropless one exactly where
    the reference's does."""
    jc, tc, jp, x = layer_setup
    jn = dataclasses.replace(jc, capacity_factor=float(jc.n_experts))
    tn = dataclasses.replace(tc, capacity_factor=float(tc.n_experts))
    yj, _, yt, _ = _run(jc, tc, jp, x, "apply_moe_gshard")
    yjn, _, ytn, _ = _run(jn, tn, jp, x, "apply_moe_ragged")
    drop_j = np.abs(yj - yjn).max(-1) > 1e-4
    drop_t = np.abs(yt - ytn).max(-1) > 1e-4
    assert drop_j.any(), "no token dropped: the case checks nothing"
    np.testing.assert_array_equal(drop_t, drop_j)


def test_router_ties_take_the_lower_expert():
    """``jax.lax.top_k`` takes the lower index first on a tie; so does the
    port (a zero input routes uniformly: every probability ties)."""
    jc, tc = _cfgs("mixtral-8x22b")
    jp, _ = unbox_tree(JL.init_moe(jax.random.key(0), jc))
    x = np.zeros((1, 4, jc.d_model), np.float32)
    x[0, 1] = 0.3
    _, top_i, _ = TL._route(torch.tensor(np.asarray(jp["router"])),
                            torch.tensor(x), 2, tc.n_experts)
    _, jt = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jp["router"], -1), 2)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jt))
    assert top_i[0, 0].tolist() == [0, 1]


# -- the port's counterparts of tests/test_moe.py -------------------------

@pytest.fixture(scope="module")
def port_setup():
    cfg = TR.get("mixtral-8x22b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = TL.init_moe(gen, cfg, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen) * 0.5
    return cfg, ActivationEngine(cfg.activation), params, x


def test_gshard_equals_ragged_without_drops(port_setup):
    cfg, eng, params, x = port_setup
    cfg_nd = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    y_g, aux_g = TL.apply_moe_gshard(params, x, cfg_nd, eng)
    y_r, aux_r = TL.apply_moe_ragged(params, x, cfg_nd, eng)
    torch.testing.assert_close(y_g.float(), y_r.float(), atol=2e-2,
                               rtol=2e-2)
    assert float(aux_g) == pytest.approx(float(aux_r), rel=1e-5)


def test_gshard_topk_slots_both_used(port_setup):
    cfg, eng, params, x = port_setup
    cfg_nd = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    y2, _ = TL.apply_moe_gshard(params, x, cfg_nd, eng)
    y1, _ = TL.apply_moe_gshard(params, x,
                                dataclasses.replace(cfg_nd, top_k=1), eng)
    assert float((y2.float() - y1.float()).abs().max()) > 1e-3


def test_gshard_capacity_drops_bounded(port_setup):
    cfg, eng, params, x = port_setup
    y_g, _ = TL.apply_moe_gshard(params, x, cfg, eng)
    assert bool(torch.isfinite(y_g).all())
    cfg_nd = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    y_r, _ = TL.apply_moe_ragged(params, x, cfg_nd, eng)
    agree = float(((y_g.float() - y_r.float()).abs() < 2e-2).float().mean())
    assert agree > 0.3, agree


@pytest.mark.parametrize("fn", ["apply_moe_gshard", "apply_moe_ragged"])
def test_moe_grads_flow(port_setup, fn):
    cfg, eng, params, x = port_setup
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    y, aux = getattr(TL, fn)(p, x, cfg, eng)
    grads = torch.autograd.grad((y.float() ** 2).sum() + aux, tree_leaves(p))
    norms = [float(g.norm()) for g in grads]
    assert all(np.isfinite(norms)) and all(n > 0 for n in norms), norms


# -- through the model ----------------------------------------------------

def _model(arch, impl, **over):
    jc, tc = _cfgs(arch, moe_impl=impl, **over)
    jp, _ = JM.materialize_params(jc, seed=0)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_loss_aux_and_grads_match_reference(arch, impl):
    """loss_fn (nll + aux + z-loss) and its gradients for the router, the
    expert stacks and the shared expert, at f32: port vs ``jax.grad``
    of the reference, 1e-4 relative."""
    jc, tc, jp, tp = _model(arch, impl)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 512, (2, 16)).astype(np.int32)
    labels = rng.randint(0, 512, (2, 16)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jbatch, jc, JS.make_engine(jc),
                             remat="none"), has_aux=True)(jp)
    leaf = tree_map(lambda t: t.detach().requires_grad_(), tp)
    tl, tm = TM.loss_fn(leaf, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)},
                        tc, TS.make_engine(tc), remat="none")
    leaves = tree_leaves(leaf)
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(tl, leaves)))
    tg = tree_map(lambda t: by_id[id(t)], leaf)
    aux, total = float(tm["aux"].detach()), float(tl.detach())
    assert aux > 0
    assert _rel(aux, float(jm["aux"])) <= 1e-4
    assert _rel(total, float(jl)) <= 1e-4
    names = ["router", "w_gate", "w_up", "w_down"]
    if tc.shared_expert:
        names += ["shared"]
    for name in names:
        jt, tt = jg["blocks"]["ffn"][name], tg["blocks"]["ffn"][name]
        for a, b in zip(tree_leaves(tt), jax.tree.leaves(jt)):
            assert _rel(a.numpy(), b) <= 1e-4, (name, _rel(a.numpy(), b))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_serve_tokens_match_reference(arch, impl):
    """Greedy tokens of the port's ServeEngine on its default paged cache
    equal the reference's, request by request, at f32 (gshard: the same
    capacity drops in every prefill group and decode step)."""
    jc, tc, jp, tp = _model(arch, impl)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (9, 17, 30, 12)]
    kw = dict(slots=2, chunk=4, max_prompt_len=32, max_len=40)
    jeng = JServeEngine(jc, jp, JEngineConfig(**kw))
    teng = ServeEngine(tc, tp, EngineConfig(**kw), device="cpu")
    assert teng.paged
    for p in prompts:
        jeng.submit(p, max_new=6)
        teng.submit(p, max_new=6)
    assert [c.tokens for c in teng.run()] == [c.tokens for c in jeng.run()]


@pytest.mark.parametrize("arch", MOE)
def test_train_step_under_remat_matches_none(arch):
    """The port's train step on an MoE model (gshard, f32): the block
    checkpoint reruns each layer's forward, router and dispatch included,
    and gives the loss, aux and new params of remat="none"."""
    from repro_torch.optim import adamw
    _, tc = _cfgs(arch, moe_impl="gshard")
    params = TM.materialize_params(tc, seed=0, device="cpu")
    rng = np.random.RandomState(6)
    batch = {k: torch.from_numpy(rng.randint(0, 512, (2, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    out = {}
    for remat in ("none", "block"):
        step = TS.make_train_step(tc, TS.TrainHyper(remat=remat))
        new, _, m = step(params, adamw.init_state(params), batch, 5)
        out[remat] = (new, m)
    (pn, mn), (pb, mb) = out["none"], out["block"]
    assert float(mn["aux"]) > 0 and int(mb["skipped"]) == 0
    for k in ("loss", "aux", "gnorm"):
        assert float(mb[k]) == pytest.approx(float(mn[k]), rel=1e-6), k
    for a, b in zip(tree_leaves(pb), tree_leaves(pn)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_compute_params_casts_experts_not_router():
    """The expert stacks and the shared expert are cast to the compute
    dtype once; the router stays f32 (it routes in f32)."""
    cfg = TR.get("llama4-scout-17b-a16e", smoke=True)
    cp = TM.compute_params(TM.materialize_params(cfg, seed=0, device="cpu"),
                           cfg)
    ffn = cp["blocks"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        assert ffn[name].dtype == torch.bfloat16
        assert ffn["shared"][name].dtype == torch.bfloat16
    assert ffn["w_gate"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                   cfg.d_ff)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b", "yi-34b"] + list(MOE))
def test_full_param_counts_match_reference(arch):
    jc, tc = JR.get(arch), TR.get(arch)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
