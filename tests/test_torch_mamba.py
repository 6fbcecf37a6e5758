"""Port vs reference: Mamba-1 (falcon-mamba-7b: every layer a Mamba block,
no attention, no FFN) and the hybrid block (hymba-1.5b: attention and
Mamba on the same normed input, each branch normed, then averaged; a
sliding window).

On the reference's own weights, passed over as numpy, at f32: the Mamba
block's output and carried conv / ssm state within 1e-5 (a sequence
split in two with the state carried, and step by step, equals one
pass); logits, ragged-prefill logits and caches, and decode steps
within 1e-5 (decode also equals the full forward at each position);
loss and every gradient against ``jax.grad`` within 1e-4 relative. The
served tokens of the port's ServeEngine equal the reference engine's:
exact prefill buckets, the pure-SSM fallback from the paged cache to the
slot contract, chunked prefill and prefix sharing off. Deployments:
``plain``, ``fused`` (glu_2d on hymba's FFN) and ``kernel``
(elementwise_2d on every engine nonlinearity, Mamba's three included);
on the CPU both kernels run their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.common import act_impl_of as j_act_impl_of  # noqa: E402
from repro.configs.common import fused_of as j_fused_of  # noqa: E402
from repro.core.activations import ActivationEngine as JEngine  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel.partition import unbox_tree  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.core.activations import ActivationEngine  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402

FALCON, HYMBA = "falcon-mamba-7b", "hymba-1.5b"
# (arch, deployment): falcon-mamba has no FFN to fuse
CASES = [(FALCON, "plain"), (FALCON, "kernel"),
         (HYMBA, "plain"), (HYMBA, "fused"), (HYMBA, "kernel")]
# decode: hymba's fused FFN is one glu_2d either way, its decode held
# elsewhere (test_torch_archs); gradients: the kernelized engine's
# recompute backward once (hymba: Mamba's three activations and the FFN's)
STEP_CASES = [c for c in CASES if c != (HYMBA, "fused")]
GRAD_CASES = [(FALCON, "plain"), (HYMBA, "plain"), (HYMBA, "kernel")]
TOL = 1e-5            # f32 outputs, states and logits (absolute)
GRAD_TOL = 1e-4       # loss and gradients (relative to the largest entry)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deployment(arch, dep, **over):
    jc = JR.get(arch, smoke=True, compute_dtype="float32", **over)
    tc = TR.get(arch, smoke=True, compute_dtype="float32", **over)
    if dep == "fused":
        return j_fused_of(jc), fused_of(tc)
    if dep == "kernel":
        return (j_act_impl_of(jc, "cr_spline", use_kernel=True),
                act_impl_of(tc, "cr_spline", use_kernel=True))
    return jc, tc


def shared_params(jc, tc, seed=0):
    jp, _ = JM.materialize_params(jc, seed=seed)
    return jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def tokens(S, B=2, seed=0):
    return np.random.RandomState(seed).randint(0, 512, (B, S)).astype(
        np.int32)


# --- the Mamba block ------------------------------------------------------

def _mamba(dep):
    """(reference cfg, port cfg, reference params, port params, engines)
    of falcon-mamba's Mamba block."""
    jc, tc = deployment(FALCON, dep)
    jp = unbox_tree(JL.init_mamba(jax.random.key(3), jc))[0]
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jc, tc, jp, tp, JEngine(jc.activation), ActivationEngine(
        tc.activation)


def _states(cfg, B, seed):
    rng = np.random.RandomState(seed)
    conv = rng.randn(B, cfg.conv_kernel - 1, cfg.d_inner_).astype(np.float32)
    ssm = rng.randn(B, cfg.d_inner_, cfg.ssm_state).astype(np.float32) * 0.1
    return conv, ssm


@pytest.mark.parametrize("dep", ["plain", "kernel"])
def test_mamba_block_output_and_state_match_reference(dep):
    """apply_mamba from a carried (nonzero) conv / ssm state: the output
    and both new states within 1e-5 of the reference's."""
    jc, tc, jp, tp, je, te = _mamba(dep)
    x = np.random.RandomState(1).randn(2, 11, jc.d_model).astype(
        np.float32) * 0.5
    conv, ssm = _states(jc, 2, 2)
    jo = JL.apply_mamba(jp, jnp.asarray(x), jc, je, jnp.asarray(conv),
                        jnp.asarray(ssm))
    to = TL.apply_mamba(tp, torch.from_numpy(x), tc, te,
                        torch.from_numpy(conv), torch.from_numpy(ssm))
    assert [tuple(t.shape) for t in to] == [j.shape for j in jo]
    for got, want in zip(to, jo):
        close(got, want)


@pytest.mark.parametrize("dep", ["plain", "kernel"])
def test_mamba_split_and_stepwise_equal_one_pass(dep):
    """A sequence split in two with the state carried, and the same
    sequence one token at a time, give the one-pass output and state."""
    _, tc, _, tp, _, te = _mamba(dep)
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 12, tc.d_model).astype(np.float32) * 0.5)
    full, conv, ssm = TL.apply_mamba(tp, x, tc, te)
    a, cs, ss = TL.apply_mamba(tp, x[:, :5], tc, te)
    b, cs, ss = TL.apply_mamba(tp, x[:, 5:], tc, te, cs, ss)
    close(torch.cat([a, b], dim=1), full.numpy())
    close(cs, conv.numpy())
    close(ss, ssm.numpy())
    outs, cs, ss = [], None, None
    for t in range(x.shape[1]):
        y, cs, ss = TL.apply_mamba(tp, x[:, t:t + 1], tc, te, cs, ss)
        outs.append(y)
    close(torch.cat(outs, dim=1), full.numpy())
    close(ss, ssm.numpy())


def test_mamba_params_init_like_reference():
    """init_mamba: the reference's shapes, S4D-real A_log, D = 1, a zero
    conv bias, and dt_proj_b the inverse softplus of a step in
    [1e-3, 1e-1]."""
    cfg = TR.get(FALCON, smoke=True)
    p = TL.init_mamba(torch.Generator().manual_seed(0), cfg, "cpu")
    jp = unbox_tree(JL.init_mamba(jax.random.key(0),
                                  JR.get(FALCON, smoke=True)))[0]
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp.items()}
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-6)
    assert bool((p["D"] == 1).all()) and bool((p["conv_b"] == 0).all())
    dt = torch.nn.functional.softplus(p["dt_proj_b"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)


# --- the model ------------------------------------------------------------

@pytest.mark.parametrize("arch", [FALCON, HYMBA])
def test_param_tree_matches_reference(arch):
    """Same key paths and shapes as the reference's tree (falcon-mamba:
    no attention; hymba: both branches and their output norms)."""
    tp = TM.materialize_params(TR.get(arch, smoke=True), seed=0,
                               device="cpu")
    jp, _ = JM.materialize_params(JR.get(arch, smoke=True), seed=0)
    jflat = {jax.tree_util.keystr(k): v.shape for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + f"[{k!r}]")
        else:
            tflat[path] = tuple(t.shape)
    walk(tp, "")
    assert tflat == jflat
    assert ("['blocks']['attn']['wq']" in tflat) == (arch == HYMBA)
    assert "['blocks']['mamba']['A_log']" in tflat


@pytest.mark.parametrize("arch,dep", CASES)
def test_logits_prefill_and_cache_match_reference(arch, dep):
    """forward_fn logits, and a ragged prefill (rows of the bucket's full
    length, as the engine's exact buckets give) with its per-layer conv /
    ssm state (and hymba's ring and k_pos)."""
    jc, tc = deployment(arch, dep)
    jp, tp = shared_params(jc, tc)
    toks = tokens(13)
    jl = JM.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jc,
                       JS.make_engine(jc))
    tl = TM.forward_fn(tp, {"tokens": torch.from_numpy(toks)}, tc,
                       TS.make_engine(tc))
    close(tl, jl)
    lens = np.array([13, 13], np.int32)
    jlp, jcache = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                                     "lengths": jnp.asarray(lens)}, jc,
                                JS.make_engine(jc), capacity=24)
    tlp, tcache = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                                     "lengths": torch.from_numpy(lens)}, tc,
                                TS.make_engine(tc), capacity=24)
    close(tlp, jlp)
    assert set(tcache) == set(jcache)
    assert set(tcache["layers"]) == set(jcache["layers"])
    for name, leaf in tcache["layers"].items():
        close(leaf, jcache["layers"][name])
    if "k_pos" in jcache:
        np.testing.assert_array_equal(tcache["k_pos"].numpy(),
                                      np.asarray(jcache["k_pos"]))


@pytest.mark.parametrize("arch,dep", STEP_CASES)
def test_decode_matches_reference_and_full_forward(arch, dep):
    """Prefill 10 tokens, then decode the next 6 one at a time (hymba with
    a window of 8, so its ring of 8 wraps): each step's logits equal the
    reference's and the full forward's at that position."""
    jc, tc = deployment(arch, dep, **({"sliding_window": 8}
                                      if arch == HYMBA else {}))
    jp, tp = shared_params(jc, tc)
    toks = tokens(16, seed=2)
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    full = TM.forward_fn(tp, {"tokens": torch.from_numpy(toks)}, tc, te)
    jl, jcache = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks[:, :10])},
                               jc, je, capacity=8)
    tl, tcache = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :10])},
                               tc, te, capacity=8)
    close(tl, jl)
    for t in range(10, 16):
        step = toks[:, t:t + 1]
        jl, jcache = JM.decode_fn(jp, {"tokens": jnp.asarray(step)}, jcache,
                                  jc, je)
        tl, tcache = TM.decode_fn(tp, {"tokens": torch.from_numpy(step)},
                                  tcache, tc, te)
        close(tl, jl)
        close(tl, full[:, t].numpy())
    for name, leaf in tcache["layers"].items():
        close(leaf, jcache["layers"][name])


@pytest.mark.parametrize("arch,dep", GRAD_CASES)
def test_loss_and_grads_match_reference(arch, dep):
    """loss_fn and the gradient of every leaf against ``jax.grad`` of the
    reference's loss, f32, 1e-4 relative."""
    jc, tc = deployment(arch, dep)
    jp, tp = shared_params(jc, tc)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 512, (2, 12)).astype(np.int32)
    labels = rng.randint(0, 512, (2, 12)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jbatch, jc, JS.make_engine(jc),
                             remat="none"), has_aux=True)(jp)
    leaf = tree_map(lambda t: t.detach().requires_grad_(), tp)
    tl, _ = TM.loss_fn(leaf, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)},
                       tc, TS.make_engine(tc), remat="none")
    leaves = tree_leaves(leaf)
    got = torch.autograd.grad(tl, leaves, allow_unused=True,
                              materialize_grads=True)
    assert _rel(float(tl.detach()), float(jl)) <= GRAD_TOL
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if np.abs(np.asarray(w)).max() > 0:
            assert _rel(g.numpy(), w) <= GRAD_TOL, (g.shape, _rel(g, w))
    by_id = dict(zip(map(id, leaves), got))
    assert all(float(by_id[id(t)].abs().max()) > 0
               for t in tree_leaves(leaf["blocks"]["mamba"]))


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("arch", [FALCON, HYMBA])
def test_rational_softplus_raises_like_reference(arch, kernel):
    """Mamba's softplus under the rational scheme: the reference has no
    residual build for it and raises at the first forward (the step
    build's softplus check looks only at the FFN); the port raises the
    same, kernelized or not, with no fallback."""
    jc = j_act_impl_of(JR.get(arch, smoke=True), "rational",
                       use_kernel=kernel)
    tc = act_impl_of(TR.get(arch, smoke=True), "rational", use_kernel=kernel)
    toks = tokens(5)
    jp, tp = shared_params(jc, tc)
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    with pytest.raises(ValueError, match="tanh only"):
        JM.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jc, je)
    with pytest.raises(ValueError, match="tanh only"):
        TM.forward_fn(tp, {"tokens": torch.from_numpy(toks)}, tc, te)


# --- serving --------------------------------------------------------------

def make_prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (int(n),)).astype(np.int32) for n in lens]


def serve_both(jc, tc, jp, tp, prompts, gen, *, slots=2, chunk=4,
               max_prompt=32, **ecfg):
    """Greedy tokens of the reference's and the port's ServeEngine on the
    same requests and EngineConfig: (reference, port, port engine)."""
    kw = dict(slots=slots, chunk=chunk, max_prompt_len=max_prompt,
              max_len=max_prompt + gen, **ecfg)
    jeng = JServeEngine(jc, jp, JEngineConfig(**kw))
    teng = ServeEngine(tc, tp, EngineConfig(**kw), device="cpu")
    for p in prompts:
        jeng.submit(p, max_new=gen)
        teng.submit(p, max_new=gen)
    ref, got = jeng.run(), teng.run()
    assert [c.finish_reason for c in got] == [c.finish_reason for c in ref]
    return [c.tokens for c in ref], [c.tokens for c in got], teng


@pytest.mark.parametrize("dep", ["plain", "kernel"])
def test_exact_buckets_batch_equal_lengths_only(dep):
    """SSM archs prefill at exact lengths: the batch pop groups only
    equal-length prompts (the three 11s, then the 7), and the tokens are
    the reference engine's."""
    jc, tc = deployment(FALCON, dep)
    jp, tp = shared_params(jc, tc)
    ref, got, eng = serve_both(jc, tc, jp, tp,
                               make_prompts([11, 11, 7, 11], seed=6), 6,
                               slots=4)
    assert eng.stats.prefill_batches == 2
    assert eng.stats.prefill_padded_tokens == eng.stats.prefill_tokens
    assert got == ref


@pytest.mark.parametrize("dep", ["plain", "kernel"])
def test_ssm_arch_falls_back_to_slot(dep):
    """A pure-SSM stack has no KV ring to page: cache='paged' serves on
    the slot contract (no k/v, no k_pos) with the slot run's tokens, which
    are the reference's."""
    jc, tc = deployment(FALCON, dep)
    jp, tp = shared_params(jc, tc)
    prompts = make_prompts([9, 13], seed=5)
    ref, paged, eng = serve_both(jc, tc, jp, tp, prompts, 6, cache="paged")
    assert not eng.paged and not eng.prefix_enabled
    assert set(eng.cache) == {"layers", "cur"}
    assert set(eng.cache["layers"]) == {"conv", "ssm"}
    slot = ServeEngine(tc, tp, EngineConfig(
        slots=2, chunk=4, max_prompt_len=32, max_len=38, cache="slot"),
        device="cpu")
    for p in prompts:
        slot.submit(p, max_new=6)
    assert paged == [c.tokens for c in slot.run()] == ref
    with pytest.raises(ValueError, match="nothing to page"):
        TM.init_paged_cache(tc, 2, 9, 16, 32, device="cpu")


@pytest.mark.parametrize("arch,dep", [(FALCON, "plain"), (FALCON, "kernel"),
                                      (HYMBA, "plain"), (HYMBA, "kernel")])
def test_chunked_requires_paged_attention(arch, dep):
    """SSM state cannot resume mid-prompt: with chunk_prefill the engine
    keeps one-shot admission (and no prefix sharing), as the reference's."""
    _, tc = deployment(arch, dep)
    tp = TM.materialize_params(tc, seed=0, device="cpu")
    eng = ServeEngine(tc, tp, EngineConfig(
        slots=1, chunk=4, max_prompt_len=32, max_len=38, chunk_prefill=4),
        device="cpu")
    eng.submit(make_prompts([9], seed=6)[0], max_new=6)
    done = eng.run()
    assert not eng.chunked and eng.stats.prefill_chunks == 0
    assert not eng.prefix_enabled
    assert eng.paged == (arch == HYMBA)
    assert len(done) == 1 and len(done[0].tokens) == 6


@pytest.mark.parametrize("dep", ["plain", "fused", "kernel"])
def test_hybrid_serve_tokens_match_reference(dep):
    """hymba on the paged cache (its conv / ssm per slot beside the page
    pool), prompts of mixed lengths through two recycled slots, decoding
    past the smoke window of 32: the reference engine's tokens."""
    jc, tc = deployment(HYMBA, dep)
    jp, tp = shared_params(jc, tc)
    ref, got, eng = serve_both(jc, tc, jp, tp,
                               make_prompts([9, 30, 17], seed=3), 6)
    assert eng.paged and not eng.prefix_enabled
    assert set(eng.cache["layers"]) == {"k", "v", "conv", "ssm"}
    assert eng.cache["layers"]["ssm"].shape[1] == eng.ecfg.slots
    assert got == ref
