"""Per-layer approximant assignments (``act_layers``) in the port: the
counterparts of ``tests/test_per_layer_act.py::TestPerLayerAssignment``,
and mixed assignments against the reference on its own weights.

A uniform assignment collapses to one ActivationEngine, a mixed one is a
``LayerEngines`` whose distinct engines each bind their own
``params["act"]`` leaf; every stack runner runs layer i under layer i's
engine. f32 logits within 1e-4 of the reference's (as
``tests/test_torch_model.py``) under the plain, fused (glu_2d on every
FFN, each layer with its own scheme's params) and kernelized
(elementwise_2d) deployments, and with a bit-accurate ``*_fixed`` layer
(5e-4, as ``tests/test_torch_fixed_model.py``: a one-LSB flip of the
quantized activation from another GEMM order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.common import act_layers_of as j_act_layers_of  # noqa: E402
from repro.configs.common import fused_of as j_fused_of  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, act_layers_of  # noqa: E402
from repro_torch.core.activations import (ActivationEngine,  # noqa: E402
                                          LayerEngines)
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402

MIXED = ("cr-d32", "pwl-d16", "poly-d8-g3", "rational-d32-g5")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestPerLayerAssignment:
    def test_uniform_pin_collapses_to_plain_engine(self):
        cfg = TR.get("qwen3-0.6b", smoke=True)
        pinned = act_layers_of(cfg, ("pwl",) * cfg.n_layers)
        layer_cfgs = pinned.layer_activation_configs()
        assert len(set(layer_cfgs)) == 1
        engines = LayerEngines(layer_cfgs)
        assert len(engines.distinct) == 1 and len(engines.segments) == 1
        assert isinstance(TS.make_engine(pinned), ActivationEngine)

    def test_act_layers_and_act_impl_mutually_exclusive(self):
        cfg = TR.get("qwen3-0.6b", smoke=True)
        bad = dataclasses.replace(cfg, act_impl="pwl",
                                  act_layers=("pwl",) * cfg.n_layers)
        with pytest.raises(ValueError, match="mutually"):
            bad.layer_activation_configs()
        with pytest.raises(ValueError):
            act_layers_of(cfg, ("pwl",))      # wrong length

    def test_segments_and_bind(self):
        """Maximal same-engine runs, and each distinct engine bound to its
        own tagged leaf."""
        cfg = act_layers_of(TR.get("qwen3-0.6b", smoke=True, n_layers=4),
                            ("cr-d32", "cr-d32", "pwl-d16", "cr-d32"))
        eng = TS.make_engine(cfg)
        assert [(s, t) for s, t, _ in eng.segments] == [(0, 2), (2, 3),
                                                        (3, 4)]
        assert len(eng.distinct) == 2
        params = TM.materialize_params(cfg, seed=0, device="cpu")
        assert set(params["act"]) == {"cr-d32", "pwl-d16"}
        bound = eng.bind(params["act"])
        assert bound.engines[0] is bound.engines[3]
        for e in bound.engines:
            assert e.act_params is not None
            assert torch.equal(e.act_params, params["act"][e.cfg.tag()])

    def test_pinned_per_layer_serves_identical_to_global_impl(self):
        base = TR.get("qwen3-0.6b", smoke=True)
        params = TM.materialize_params(base, seed=0, device="cpu")
        rng = np.random.RandomState(9)
        prompts = [rng.randint(0, base.vocab_size, (n,)).astype(np.int32)
                   for n in (9, 17, 12)]

        def serve(cfg):
            eng = ServeEngine(cfg, params, EngineConfig(
                slots=2, max_prompt_len=32, max_len=40, chunk=4),
                device="cpu")
            for p in prompts:
                eng.submit(p, max_new=6, temperature=0.8)
            return {c.uid: c.tokens for c in eng.run()}

        by_impl = serve(act_impl_of(base, "pwl"))
        by_map = serve(act_layers_of(base, ("pwl",) * base.n_layers))
        assert by_map == by_impl

    def test_mixed_assignment_serves_and_matches_forward(self):
        """A mixed model serves through ServeEngine (paged) and greedily
        matches the lockstep prefill + decode built from the same
        engines."""
        base = TR.get("qwen3-0.6b", smoke=True)
        cfg = act_layers_of(base, ("cr-d32", "pwl-d16"))
        params = TM.materialize_params(cfg, seed=0, device="cpu")
        engine = TS.make_engine(cfg)
        assert isinstance(engine, LayerEngines)
        prompt = np.arange(1, 12, dtype=np.int32)
        gen = 6
        eng = ServeEngine(cfg, params, EngineConfig(
            slots=2, max_prompt_len=32, max_len=40, chunk=3), device="cpu")
        eng.submit(prompt, max_new=gen)
        done = eng.run()

        cp = TM.compute_params(params, cfg)
        logits, cache = TM.prefill_fn(
            cp, {"tokens": torch.from_numpy(prompt[None, :])}, cfg, engine,
            capacity=eng.capacity)
        tok = logits.argmax(-1).to(torch.int32)
        ref = [int(tok[0])]
        for _ in range(gen - 1):
            logits, cache = TM.decode_fn(cp, {"tokens": tok[:, None]}, cache,
                                         cfg, engine)
            tok = logits.argmax(-1).to(torch.int32)
            ref.append(int(tok[0]))
        assert done[0].tokens == ref

    def test_act_params_frozen_by_default(self):
        cfg = act_layers_of(TR.get("olmo-1b", smoke=True),
                            ("pwl-d16", "cr-d32"))
        params = TM.materialize_params(cfg, seed=0, device="cpu")
        assert set(params["act"]) == {"pwl-d16", "cr-d32"}
        opt = adamw.init_state(params)
        step = TS.make_train_step(cfg, TS.TrainHyper(remat="none"))
        batch = {"tokens": torch.ones((2, 16), dtype=torch.int32),
                 "labels": torch.ones((2, 16), dtype=torch.int32)}
        params2, _, m = step(params, opt, batch, 50)
        assert int(m["skipped"]) == 0
        for t, a in params2["act"].items():
            assert torch.equal(a, params["act"][t]), t
        assert not torch.equal(params2["embed"], params["embed"])

    def test_act_gradients_flow_when_bound(self):
        cfg = act_layers_of(TR.get("olmo-1b", smoke=True),
                            ("pwl-d16", "cr-d32"))
        params = TM.materialize_params(cfg, seed=0, device="cpu")
        engine = TS.make_engine(cfg)
        leaf = tree_map(lambda t: t.detach().requires_grad_(), params)
        batch = {"tokens": torch.ones((2, 16), dtype=torch.int32),
                 "labels": torch.ones((2, 16), dtype=torch.int32)}
        loss, _ = TM.loss_fn(leaf, batch, cfg, engine, remat="none")
        acts = tree_leaves(leaf["act"])
        grads = torch.autograd.grad(loss, acts)
        for g in grads:
            assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def _mixed(dep, layers=MIXED):
    """(reference config, port config) of qwen3-0.6b smoke at four layers
    under a mixed assignment, f32: ``plain``, ``fused`` (the reference's
    fused_of over the assignment) or ``kernel`` (use_kernel on every
    layer)."""
    over = dict(compute_dtype="float32", n_layers=len(layers))
    jc = JR.get("qwen3-0.6b", smoke=True, **over)
    tc = TR.get("qwen3-0.6b", smoke=True, **over)
    kernel = True if dep in ("fused", "kernel") else None
    jc = j_act_layers_of(jc, layers, use_kernel=kernel)
    tc = act_layers_of(tc, layers, use_kernel=kernel)
    if dep == "fused":
        jc = dataclasses.replace(jc, fuse_mlp=True)
        tc = dataclasses.replace(tc, fuse_mlp=True)
    return jc, tc


@pytest.mark.parametrize("dep,layers,tol", [
    ("plain", MIXED, 1e-4), ("fused", MIXED, 1e-4), ("kernel", MIXED, 1e-4),
    ("plain", ("cr-d32", "pwl_fixed-d32", "cr_fixed-d32", "pwl-d16"), 5e-4)])
def test_mixed_logits_match_reference(dep, layers, tol):
    jc, tc = _mixed(dep, layers)
    if dep == "fused":
        assert j_fused_of(jc).fuse_mlp
    te = TS.make_engine(tc)
    assert isinstance(te, LayerEngines)
    assert len(te.distinct) == len(set(layers))
    jp, _ = JM.materialize_params(jc, seed=0)
    assert set(jp["act"]) == {c.tag() for c in tc.layer_activation_configs()}
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    assert set(tp["act"]) == set(jp["act"])
    toks = np.random.RandomState(0).randint(0, 512, (2, 19)).astype(np.int32)
    jl = JM.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jc,
                       JS.make_engine(jc))
    tl = TM.forward_fn(tp, {"tokens": torch.from_numpy(toks)}, tc, te)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    lens = np.array([19, 7], np.int32)
    jlp, _ = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                                "lengths": jnp.asarray(lens)}, jc,
                           JS.make_engine(jc), capacity=32)
    tlp, _ = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                                "lengths": torch.from_numpy(lens)}, tc, te,
                           capacity=32)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("dep,schedule", [
    ("fused", "one_shot"), ("kernel", "one_shot"), ("fused", "prefix"),
    ("kernel", "chunked")])
def test_mixed_serve_tokens_match_reference(dep, schedule):
    """Greedy tokens of a mixed assignment through both ServeEngines
    (paged), request by request: one-shot admission, prefix-page hits
    (serial admission, a shared 2-page prefix: the prefix runner) and
    chunked prefill (the chunk runner)."""
    jc, tc = _mixed(dep)
    jp, _ = JM.materialize_params(jc, seed=0)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.RandomState(3)
    kw = dict(slots=2, chunk=4, max_prompt_len=32, max_len=38)
    if schedule == "prefix":
        shared = rng.randint(0, 512, (16,)).astype(np.int32)
        prompts = [np.concatenate([shared, rng.randint(0, 512, (n,))])
                   .astype(np.int32) for n in (5, 9, 1)]
        kw.update(page_size=8, admission="serial")
    else:
        prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
                   for n in (9, 17, 30, 12)]
    if schedule == "chunked":
        kw.update(chunk_prefill=8)
    jeng = JServeEngine(jc, jp, JEngineConfig(**kw))
    teng = ServeEngine(tc, tp, EngineConfig(**kw), device="cpu")
    for p in prompts:
        jeng.submit(p, max_new=6)
        teng.submit(p, max_new=6)
    assert [c.tokens for c in teng.run()] == [c.tokens for c in jeng.run()]
    if schedule == "prefix":
        assert teng.stats.prefix_hit_tokens == jeng.stats.prefix_hit_tokens \
            > 0
    if schedule == "chunked":
        assert teng.stats.prefill_chunks > 0


def test_launcher_trains_under_act_layers(tmp_path):
    summary = train_mod.main(["--act-layers", "pwl-d16,cr-d32", "--smoke",
                              "--device", "cpu", "--steps", "2",
                              "--ckpt-dir", str(tmp_path), "--log-every",
                              "0"])
    assert summary["arch"] == "olmo-1b-smoke" and summary["steps"] == 2
    assert summary["skipped"] == 0 and np.isfinite(summary["loss_first"])
