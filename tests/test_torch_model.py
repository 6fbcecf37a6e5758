"""Port vs reference: the dense LM on the reference's own weights.

The reference's params (jax.random init) cross over as numpy through
``params_from_numpy``; both packages then compute forward and ragged
prefill logits on the same tokens, under the plain config, the fused
deployment (``fused_of``: ``glu_2d`` on every FFN) and the kernelized
engine (``act_impl_of(cfg, "cr_spline", use_kernel=True)``:
``elementwise_2d`` on every FFN activation).

Tolerances: f32 compute <= 1e-4 absolute on the logits (measured ~3e-6).
bf16 compute <= 0.1 absolute on logits of magnitude ~4-5 (measured ~0.05):
the two frameworks round bf16 at different places (XLA may keep f32
between fused ops), so only the f32 comparison speaks for the algorithm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.common import act_impl_of as j_act_impl_of  # noqa: E402
from repro.configs.common import fused_of as j_fused_of  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.core.activations import LayerEngines  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 0.1}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deployments(arch, dtype, dep, scheme=None):
    """(reference config, port config) of one deployment: ``plain`` (the
    unfused engine), ``kernel`` (every FFN activation one elementwise_2d
    launch) or ``fused`` (every FFN one glu_2d launch), under the arch's
    own scheme or ``scheme``."""
    jc = JR.get(arch, smoke=True, compute_dtype=dtype)
    tc = TR.get(arch, smoke=True, compute_dtype=dtype)
    if scheme is not None:
        jc, tc = j_act_impl_of(jc, scheme), act_impl_of(tc, scheme)
    if dep == "fused":
        return j_fused_of(jc), fused_of(tc)
    if dep == "kernel":
        scheme = scheme or "cr_spline"
        return (j_act_impl_of(jc, scheme, use_kernel=True),
                act_impl_of(tc, scheme, use_kernel=True))
    return jc, tc


def shared_params(jc, tc, seed=0):
    jp, _ = JM.materialize_params(jc, seed=seed)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jp, tp


@pytest.mark.parametrize("dep", ["plain", "fused", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "paper_tanh"])
def test_forward_and_prefill_logits_match(arch, dtype, dep):
    jc, tc = deployments(arch, dtype, dep)
    jp, tp = shared_params(jc, tc)
    toks = np.random.RandomState(0).randint(0, 512, (2, 21)).astype(np.int32)
    tol = TOL[dtype]

    jl = JM.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jc,
                       JS.make_engine(jc))
    tl = TM.forward_fn(tp, {"tokens": torch.from_numpy(toks)}, tc,
                       TS.make_engine(tc))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)

    lens = np.array([21, 13], np.int32)
    jlp, jcache = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                                     "lengths": jnp.asarray(lens)}, jc,
                                JS.make_engine(jc), capacity=40)
    tlp, tcache = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                                     "lengths": torch.from_numpy(lens)}, tc,
                                TS.make_engine(tc), capacity=40)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(tcache["k_pos"].numpy(),
                                  np.asarray(jcache["k_pos"]))
    np.testing.assert_array_equal(tcache["cur"].numpy(),
                                  np.asarray(jcache["cur"]))
    np.testing.assert_allclose(tcache["layers"]["k"].float().numpy(),
                               np.asarray(jcache["layers"]["k"], np.float32),
                               rtol=0, atol=tol)


def test_decode_steps_match_reference():
    """Lockstep prefill (scalar cur) then decode steps through a ring that
    wraps: logits agree at f32."""
    jc, tc = deployments("qwen3-0.6b", "float32", "fused")
    jp, tp = shared_params(jc, tc)
    toks = np.random.RandomState(1).randint(0, 512, (2, 12)).astype(np.int32)
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    jl, jcache = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jc, je,
                               capacity=10)
    tl, tcache = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, tc, te,
                               capacity=10)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jcache = JM.decode_fn(jp, {"tokens": jnp.asarray(nxt)}, jcache,
                                  jc, je)
        tl, tcache = TM.decode_fn(tp, {"tokens": torch.from_numpy(nxt)},
                                  tcache, tc, te)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    np.testing.assert_array_equal(tcache["k_pos"].numpy(),
                                  np.asarray(jcache["k_pos"]))


def test_materialize_params_matches_reference_tree():
    """Same key paths, shapes and initializer scales as the reference."""
    cfg = TR.get("qwen3-0.6b", smoke=True, n_layers=3)
    jcfg = JR.get("qwen3-0.6b", smoke=True, n_layers=3)
    tp = TM.materialize_params(cfg, seed=0, device="cpu")
    jp, _ = JM.materialize_params(jcfg, seed=0)
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + f"[{k!r}]")
        else:
            tflat[path] = t
    walk(tp, "")
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert v.dtype == torch.float32
    wq = tp["blocks"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    np.testing.assert_array_equal(tp["act"]["cr-d32"].numpy(),
                                  np.asarray(jp["act"]["cr-d32"]))
    again = TM.materialize_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


def test_compute_params_cast_once_same_numbers():
    cfg = TR.get("qwen3-0.6b", smoke=True)
    tp = TM.materialize_params(cfg, seed=1, device="cpu")
    cp = TM.compute_params(tp, cfg)
    assert cp["blocks"]["ffn"]["w_gate"].dtype == torch.bfloat16
    assert cp["lm_head"].dtype == torch.float32
    assert cp["blocks"]["ln1"]["scale"].dtype == torch.float32
    toks = torch.randint(0, 512, (2, 9), generator=torch.Generator().manual_seed(0))
    eng = TS.make_engine(cfg)
    a = TM.forward_fn(tp, {"tokens": toks}, cfg, eng)
    b = TM.forward_fn(cp, {"tokens": toks}, cfg, eng)
    assert torch.equal(a, b)


def test_step_builder_contracts():
    cfg = TR.get("qwen3-0.6b", smoke=True)
    with pytest.raises(ValueError, match="fuse_mlp"):
        TS.make_engine(dataclasses.replace(
            cfg, fuse_mlp=True,
            activation=dataclasses.replace(cfg.activation, impl="exact")))
    with pytest.raises(ValueError, match="invalid activation config"):
        TS.make_engine(dataclasses.replace(cfg, act_impl="bogus"))
    assert isinstance(TS.make_engine(dataclasses.replace(
        cfg, act_layers=("cr", "exact"))), LayerEngines)
    with pytest.raises(ModuleNotFoundError):
        TR.get("no-such-arch", smoke=True)
    assert fused_of(cfg).fuse_mlp and fused_of(cfg).activation.use_kernel


@pytest.mark.parametrize("dep", ["plain", "fused", "kernel"])
@pytest.mark.parametrize("scheme", ["pwl", "poly", "rational"])
def test_scheme_logits_match_reference(scheme, dep):
    """qwen3-0.6b smoke under each scheme, on the reference's params (its
    ``params["act"]`` leaf included): f32 logits within 1e-4."""
    jc, tc = deployments("qwen3-0.6b", "float32", dep, scheme)
    jp, tp = shared_params(jc, tc)
    tag = tc.layer_activation_configs()[0].tag()
    assert tag == {"pwl": "pwl-d32", "poly": "poly-d32-g3",
                   "rational": "rational-d32-g3"}[scheme]
    assert set(tp["act"]) == set(jp["act"]) == {tag}
    np.testing.assert_array_equal(tp["act"][tag].numpy(),
                                  np.asarray(jp["act"][tag]))
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    assert te.act_impl == scheme
    toks = np.random.RandomState(3).randint(0, 512, (2, 19)).astype(np.int32)
    lens = np.array([19, 11], np.int32)
    jl, _ = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                               "lengths": jnp.asarray(lens)}, jc, je,
                          capacity=32)
    tl, _ = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                               "lengths": torch.from_numpy(lens)}, tc, te,
                          capacity=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_rational_softplus_ffn_fails_at_step_build():
    cfg = dataclasses.replace(TR.get("qwen3-0.6b", smoke=True),
                              mlp_act="softplus")
    for c in (act_impl_of(cfg, "rational"),
              fused_of(act_impl_of(cfg, "rational")),
              act_impl_of(cfg, "rational", use_kernel=True)):
        with pytest.raises(ValueError, match="tanh only"):
            TS.make_prefill_step(c)
    for scheme in ("pwl", "poly"):
        TS.make_prefill_step(fused_of(act_impl_of(cfg, scheme)))
