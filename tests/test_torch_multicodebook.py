"""Port vs reference: musicgen-large's K = 4 codebook planes (per-codebook
embeddings summed over [B, S, K] tokens, one f32 head per codebook,
[B, S, K, V] logits; a plain GELU FFN) and their serving contract, on
the reference's own weights at f32.

Logits, prefill and decode within 1e-5, loss and gradients against
``jax.grad`` within 1e-4 relative. Served greedy tokens (K-tuples) of
the port's ServeEngine equal the reference engine's, and the port keeps
the reference's contract (``tests/test_serve_multicodebook.py``): every
schedule serves the same tokens, EOS is tested on codebook 0, prompts
must be [S, K], and token stats count K plane tokens a position.
Deployments: ``plain`` and ``kernel`` (elementwise_2d on every GELU; no
gated FFN to fuse); on the CPU the kernel runs its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.common import act_impl_of as j_act_impl_of  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch.serve import serve_batch as j_serve_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402

ARCH = "musicgen-large"
DEPS = ("plain", "kernel")
TOL = 1e-5            # f32 logits (absolute, of logits ~4)
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


def deployment(dep):
    jc = JR.get(ARCH, smoke=True, compute_dtype="float32")
    tc = TR.get(ARCH, smoke=True, compute_dtype="float32")
    if dep == "kernel":
        return (j_act_impl_of(jc, "cr_spline", use_kernel=True),
                act_impl_of(tc, "cr_spline", use_kernel=True))
    return jc, tc


@pytest.fixture(scope="module", params=DEPS)
def model(request):
    """(deployment, reference cfg, port cfg, reference params, port
    params), the reference's weights carried over."""
    jc, tc = deployment(request.param)
    jp, _ = JM.materialize_params(jc, seed=0)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return request.param, jc, tc, jp, tp


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def make_prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size,
                        (int(n), cfg.n_codebooks)).astype(np.int32)
            for n in lens]


def test_param_tree_and_fusing():
    """[K, V, d] embeddings and [K, d, V] heads under the reference's key
    paths; nothing to fuse (a plain GELU FFN): ``fused_of`` is the
    identity and ``fuse_mlp`` fails the step build."""
    cfg = TR.get(ARCH, smoke=True)
    tp = TM.materialize_params(cfg, seed=0, device="cpu")
    jp, _ = JM.materialize_params(JR.get(ARCH, smoke=True), seed=0)
    K, V, d = cfg.n_codebooks, cfg.padded_vocab, cfg.d_model
    assert tuple(tp["embed"].shape) == jp["embed"].shape == (K, V, d)
    assert tuple(tp["lm_head"].shape) == jp["lm_head"].shape == (K, d, V)
    assert fused_of(cfg) == cfg
    import dataclasses
    with pytest.raises(ValueError, match="fuse_mlp"):
        TS.make_engine(dataclasses.replace(cfg, fuse_mlp=True))


def test_logits_prefill_and_decode_match_reference(model):
    """[B, S, K, V] forward logits, [B, K, V] ragged-prefill logits and
    three decode steps on [B, 1, K] tokens: within 1e-5."""
    _, jc, tc, jp, tp = model
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 512, (2, 11, jc.n_codebooks)).astype(np.int32)
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    jl = JM.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jc, je)
    tl = TM.forward_fn(tp, {"tokens": torch.from_numpy(toks)}, tc, te)
    assert tuple(tl.shape) == jl.shape == (2, 11, jc.n_codebooks,
                                           jc.padded_vocab)
    close(tl, jl)
    lens = np.array([11, 7], np.int32)
    jl, jcache = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                                    "lengths": jnp.asarray(lens)}, jc, je,
                               capacity=16)
    tl, tcache = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lens)}, tc,
                               te, capacity=16)
    close(tl, jl)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None, :]
        jl, jcache = JM.decode_fn(jp, {"tokens": jnp.asarray(nxt)}, jcache,
                                  jc, je)
        tl, tcache = TM.decode_fn(tp, {"tokens": torch.from_numpy(nxt)},
                                  tcache, tc, te)
        close(tl, jl)


def test_loss_and_grads_match_reference(model):
    """loss_fn over [B, S, K] tokens and labels and every leaf's gradient
    against ``jax.grad``: 1e-4 relative."""
    _, jc, tc, jp, tp = model
    rng = np.random.RandomState(4)
    shape = (2, 10, jc.n_codebooks)
    batch = {"tokens": rng.randint(0, 512, shape).astype(np.int32),
             "labels": rng.randint(0, 512, shape).astype(np.int32)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jc, JS.make_engine(jc), remat="none"),
        has_aux=True)(jp)
    leaf = tree_map(lambda t: t.detach().requires_grad_(), tp)
    tl, _ = TM.loss_fn(leaf, {k: torch.from_numpy(v) for k, v in
                              batch.items()}, tc, TS.make_engine(tc),
                       remat="none")
    got = torch.autograd.grad(tl, tree_leaves(leaf), allow_unused=True,
                              materialize_grads=True)
    assert _rel(float(tl.detach()), float(jl)) <= GRAD_TOL
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if np.abs(np.asarray(w)).max() > 0:
            assert _rel(g.numpy(), w) <= GRAD_TOL, (g.shape, _rel(g, w))


def serve(cfg, params, prompts, gen, *, engine=ServeEngine, slots=2,
          chunk=4, max_prompt=32, ecfg_kw=None, **submit_kw):
    """One engine run (the port's, or ``engine=JServeEngine`` the
    reference's): (completions in uid order, engine)."""
    kw = dict(slots=slots, max_prompt_len=max_prompt,
              max_len=max_prompt + gen, chunk=chunk, **(ecfg_kw or {}))
    if engine is ServeEngine:
        eng = ServeEngine(cfg, params, EngineConfig(**kw), device="cpu")
    else:
        eng = JServeEngine(cfg, params, JEngineConfig(**kw))
    for p in prompts:
        eng.submit(p, max_new=gen, **submit_kw)
    return sorted(eng.run(), key=lambda c: c.uid), eng


def test_one_shot_identity_ragged_prompts(model):
    """More requests than slots, ragged lengths: the reference engine's
    K-tuple tokens, every token K planes."""
    _, jc, tc, jp, tp = model
    prompts = make_prompts(tc, [7, 12, 5, 9, 11], seed=1)
    ref, _ = serve(jc, jp, prompts, 6, engine=JServeEngine)
    got, eng = serve(tc, tp, prompts, 6)
    assert eng.K == tc.n_codebooks and eng.paged and eng.prefix_enabled
    assert [c.tokens for c in got] == [c.tokens for c in ref]
    assert all(len(t) == tc.n_codebooks for c in got for t in c.tokens)


@pytest.mark.parametrize("ecfg_kw", [
    {"cache": "slot"},                        # per-slot rings
    {"page_size": 5},                         # page-straddling rings
    {"chunk_prefill": 5},                     # token-budget schedule
    {"chunk_prefill": 3, "token_budget": 7},  # tight budget
    {"trim_drain": False},                    # untrimmed drain
])
def test_schedule_identity(model, ecfg_kw):
    """Every schedule serves the default schedule's K-plane tokens (the
    default's are the reference engine's:
    ``test_one_shot_identity_ragged_prompts``)."""
    _, _, tc, _, tp = model
    prompts = make_prompts(tc, [9, 13, 6], seed=2)
    base, _ = serve(tc, tp, prompts, 6)
    alt, eng = serve(tc, tp, prompts, 6, ecfg_kw=ecfg_kw)
    assert eng.chunked == ("chunk_prefill" in ecfg_kw)
    assert [c.tokens for c in alt] == [c.tokens for c in base]


def test_temperature_schedule_invariant():
    """temp > 0 K-plane streams are keyed by (uid, token index): chunk
    size, chunked prefill and submission order do not change them."""
    _, tc = deployment("plain")
    tp = TM.materialize_params(tc, seed=0, device="cpu")
    prompts = make_prompts(tc, [8, 11, 6, 9], seed=3)
    base, _ = serve(tc, tp, prompts, 6, chunk=4, temperature=0.8)
    alt, _ = serve(tc, tp, prompts, 6, chunk=2, slots=3, temperature=0.8,
                   ecfg_kw={"chunk_prefill": 4})
    assert {c.uid: c.tokens for c in base} == {c.uid: c.tokens for c in alt}
    eng = ServeEngine(tc, tp, EngineConfig(slots=2, max_prompt_len=32,
                                           max_len=38, chunk=4),
                      device="cpu")
    for i, p in reversed(list(enumerate(prompts))):
        eng.submit(p, max_new=6, temperature=0.8, uid=i)
    assert {c.uid: c.tokens for c in eng.run()} == \
        {c.uid: c.tokens for c in base}
    assert any(len(set(t)) > 1 for c in base for t in c.tokens)


def test_eos_on_codebook_0_stops_row(model):
    """A row ends at the first position whose plane-0 id is eos_id; an
    id seen only on other planes never stops it; no eos_id never
    stops."""
    _, _, tc, _, tp = model
    prompts = make_prompts(tc, [9, 12], seed=4)
    free, _ = serve(tc, tp, prompts, 8)
    ref = free[0].tokens
    eos = ref[3][0]
    done, _ = serve(tc, tp, prompts, 8, eos_id=eos)
    assert done[0].finish_reason == "eos"
    cut = next(i for i, t in enumerate(ref) if t[0] == eos)
    assert done[0].tokens == ref[:cut + 1]
    other = {t[1] for t in ref} - {t[0] for t in ref}
    if other:
        done2, _ = serve(tc, tp, prompts, 8, eos_id=next(iter(other)))
        assert done2[0].tokens == ref
    assert all(c.finish_reason == "length" for c in free)


def test_admission_eos_completes_without_slot(model):
    """A first token whose plane 0 is eos completes at admission: one
    K-tuple, no decode."""
    _, _, tc, _, tp = model
    prompts = make_prompts(tc, [9], seed=5)
    done, _ = serve(tc, tp, prompts, 8)
    first = done[0].tokens[0]
    done2, eng2 = serve(tc, tp, prompts, 8, eos_id=first[0])
    assert done2[0].tokens == [first] and done2[0].finish_reason == "eos"
    assert eng2.stats.decode_tokens == 0


def test_submit_validates_prompt_shape():
    """A K > 1 engine refuses scalar-stream prompts and the wrong K."""
    _, tc = deployment("plain")
    tp = TM.materialize_params(tc, seed=0, device="cpu")
    eng = ServeEngine(tc, tp, EngineConfig(slots=1, max_prompt_len=32,
                                           max_len=40), device="cpu")
    with pytest.raises(ValueError, match="multi-codebook"):
        eng.submit(np.arange(8, dtype=np.int32), max_new=4)
    with pytest.raises(ValueError, match="multi-codebook"):
        eng.submit(np.zeros((8, tc.n_codebooks + 1), np.int32), max_new=4)


def test_stats_count_plane_tokens(model):
    """Token counters count K plane tokens a position, as the
    reference's: decode (gen - 1) positions a request, every prompt
    position prefilled, padding counted K a position."""
    _, _, tc, _, tp = model
    K = tc.n_codebooks
    prompts = make_prompts(tc, [8, 10], seed=6)
    _, eng = serve(tc, tp, prompts, 5)
    assert eng.stats.decode_tokens == len(prompts) * 4 * K
    assert eng.stats.prefill_tokens == sum(map(len, prompts)) * K
    assert eng.stats.prefill_padded_tokens == 2 * 16 * K  # min bucket 16
    assert 0.0 < eng.stats.decode_utilization(eng.ecfg.slots, K) <= 1.0


def test_serve_batch_blocks_match_reference(model):
    """serve_batch takes [B, S, K] prompts and returns the reference's
    [B, gen, K] block; planes = K in its stats."""
    _, jc, tc, jp, tp = model
    K = tc.n_codebooks
    prompts = np.random.RandomState(7).randint(
        0, tc.vocab_size, (3, 10, K)).astype(np.int32)
    got, st = serve_batch(tc, tp, prompts, 6, slots=2, chunk=3,
                          device="cpu")
    want, jst = j_serve_batch(jc, jp, jnp.asarray(prompts), 6, slots=2,
                              chunk=3)
    assert tuple(got.shape) == (3, 6, K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st.planes == jst.planes == K
    assert st.decode_tokens == jst.decode_tokens == 3 * 5 * K
