"""Port vs reference: qwen2-vl-2b's M-RoPE (each of the head_dim / 2
rotary frequencies takes the t, h or w position of its section,
``mrope_sections``) and its patch embeddings (added onto the token
embeddings), on the reference's own weights at f32.

``apply_rope`` on t / h / w positions that differ from each other within
1e-6 (broadcast positions would make M-RoPE equal RoPE and hide a wrong
section map); logits with ``patch_embeds`` and ``mrope_positions`` within
1e-5; text-only prefill and per-slot decode within 1e-5; loss and
gradients against ``jax.grad`` within 1e-4 relative; greedy tokens of
the port's ServeEngine equal to the reference engine's, with slots at
different positions, on prefix hits and under chunked prefill.
Deployments: ``plain``, ``fused`` (glu_2d on every FFN) and ``kernel``
(elementwise_2d on every activation); on the CPU both kernels run their
plain versions.
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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402

ARCH = "qwen2-vl-2b"
DEPS = ("plain", "fused", "kernel")
ROPE_TOL = 1e-6       # the rotation alone
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


def deployment(dep, **over):
    jc = JR.get(ARCH, smoke=True, compute_dtype="float32", **over)
    tc = TR.get(ARCH, smoke=True, compute_dtype="float32", **over)
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
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def vision_batch(B, S, d, seed=0):
    """Tokens, t / h / w positions that differ per section (a patch grid
    after a text prefix) and patch embeddings."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 512, (B, S)).astype(np.int32)
    t = np.arange(S)[None, :].repeat(B, 0)
    pos = np.stack([t // 4, t + 2 * (t % 3), 3 * (t % 5)], axis=-1)
    pos = (pos + rng.randint(0, 3, (B, 1, 3))).astype(np.int32)
    pe = (0.02 * rng.randn(B, S, d)).astype(np.float32)
    return toks, pos, pe


@pytest.mark.parametrize("B", [1, 3])
def test_apply_rope_mrope_matches_reference(B):
    """The rotation on distinct t / h / w positions: the reference's
    section map within 1e-6, and not plain RoPE on the t positions."""
    jc, tc = deployment("plain")
    S, H, hd = 11, 3, jc.head_dim_
    x = np.random.RandomState(B).randn(B, S, H, hd).astype(np.float32)
    _, pos, _ = vision_batch(B, S, jc.d_model, seed=B)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tc)
    close(got, want, ROPE_TOL)
    text = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]),
                         dataclasses.replace(tc, rope_kind="rope"))
    assert float((got - text).abs().max()) > 1e-2
    # broadcast positions: M-RoPE is RoPE
    same = np.repeat(pos[..., :1], 3, axis=-1)
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(same), tc),
          text.numpy(), ROPE_TOL)


def test_param_tree_matches_reference():
    """Same key paths and shapes as the reference's tree (QKV biases)."""
    tp = TM.materialize_params(TR.get(ARCH, smoke=True), seed=0,
                               device="cpu")
    jp, _ = JM.materialize_params(JR.get(ARCH, smoke=True), seed=0)
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
    assert tflat == jflat and "['blocks']['attn']['bq']" in tflat


@pytest.mark.parametrize("dep", DEPS)
def test_logits_with_patch_embeds_match_reference(dep):
    """forward_fn with patch_embeds and mrope_positions within 1e-5 of the
    reference; both inputs move the logits."""
    jc, tc = deployment(dep)
    jp, tp = shared_params(jc, tc)
    toks, pos, pe = vision_batch(2, 13, jc.d_model)
    jl = JM.forward_fn(jp, {"tokens": jnp.asarray(toks),
                            "mrope_positions": jnp.asarray(pos),
                            "patch_embeds": jnp.asarray(pe)}, jc,
                       JS.make_engine(jc))
    te = TS.make_engine(tc)
    batch = {"tokens": torch.from_numpy(toks),
             "mrope_positions": torch.from_numpy(pos),
             "patch_embeds": torch.from_numpy(pe)}
    tl = TM.forward_fn(tp, batch, tc, te)
    close(tl, jl)
    for drop in ("mrope_positions", "patch_embeds"):
        other = TM.forward_fn(tp, {k: v for k, v in batch.items()
                                   if k != drop}, tc, te)
        assert float((other - tl).abs().max()) > 1e-3, drop


@pytest.mark.parametrize("dep", DEPS)
def test_prefill_and_per_slot_decode_match_reference(dep):
    """Text-only: a ragged prefill, then decode steps with the two rows at
    different positions (all three sections advance per slot): logits
    within 1e-5 of the reference's at every step."""
    jc, tc = deployment(dep)
    jp, tp = shared_params(jc, tc)
    toks = np.random.RandomState(5).randint(0, 512, (2, 14)).astype(np.int32)
    lens = np.array([14, 6], np.int32)
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    jl, jcache = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                                    "lengths": jnp.asarray(lens)}, jc, je,
                               capacity=24)
    tl, tcache = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lens)}, tc,
                               te, capacity=24)
    close(tl, jl)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jcache = JM.decode_fn(jp, {"tokens": jnp.asarray(nxt)}, jcache,
                                  jc, je)
        tl, tcache = TM.decode_fn(tp, {"tokens": torch.from_numpy(nxt)},
                                  tcache, tc, te)
        close(tl, jl)
    np.testing.assert_array_equal(tcache["cur"].numpy(),
                                  np.asarray(jcache["cur"]))


def test_loss_and_grads_match_reference():
    """loss_fn on a batch with patch embeddings and M-RoPE positions, and
    every leaf's gradient, against ``jax.grad``: 1e-4 relative."""
    jc, tc = deployment("plain")
    jp, tp = shared_params(jc, tc)
    toks, pos, pe = vision_batch(2, 12, jc.d_model, seed=4)
    labels = np.random.RandomState(6).randint(0, 512, (2, 12)).astype(
        np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "mrope_positions": jnp.asarray(pos),
              "patch_embeds": jnp.asarray(pe)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jbatch, jc, JS.make_engine(jc),
                             remat="none"), has_aux=True)(jp)
    leaf = tree_map(lambda t: t.detach().requires_grad_(), tp)
    tl, _ = TM.loss_fn(leaf, {k: torch.from_numpy(np.array(v))
                              for k, v in jbatch.items()},
                       tc, TS.make_engine(tc), remat="none")
    got = torch.autograd.grad(tl, tree_leaves(leaf), allow_unused=True,
                              materialize_grads=True)
    assert _rel(float(tl.detach()), float(jl)) <= GRAD_TOL
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if np.abs(np.asarray(w)).max() > 0:
            assert _rel(g.numpy(), w) <= GRAD_TOL, (g.shape, _rel(g, w))


def make_prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (int(n),)).astype(np.int32) for n in lens]


def serve_both(jc, tc, jp, tp, prompts, gen, **ecfg):
    """Greedy tokens of the reference's and the port's ServeEngine on the
    same requests and EngineConfig: (reference, port, port engine)."""
    kw = dict(dict(slots=2, chunk=4, max_prompt_len=64, max_len=64 + gen),
              **ecfg)
    jeng = JServeEngine(jc, jp, JEngineConfig(**kw))
    teng = ServeEngine(tc, tp, EngineConfig(**kw), device="cpu")
    for p in prompts:
        jeng.submit(p, max_new=gen)
        teng.submit(p, max_new=gen)
    return ([c.tokens for c in jeng.run()], [c.tokens for c in teng.run()],
            teng)


@pytest.mark.parametrize("dep", ["plain", "kernel"])
def test_mrope_per_slot_positions_b2(dep):
    """Three requests through two slots at different positions: every
    decode row drives its own t / h / w sections; the reference engine's
    tokens."""
    jc, tc = deployment(dep)
    jp, tp = shared_params(jc, tc)
    ref, got, eng = serve_both(jc, tc, jp, tp, make_prompts([7, 19, 13],
                                                            seed=2), 6)
    assert eng.paged and eng.prefix_enabled
    assert got == ref


@pytest.mark.parametrize("ecfg", [
    {"chunk_prefill": 5},
    {"page_size": 8, "admission": "serial"}])
def test_chunked_and_prefix_tokens_match_reference(ecfg):
    """M-RoPE through the chunked schedule (each chunk's positions start at
    its offset) and through prefix hits (suffix positions start past the
    shared pages): the reference engine's tokens."""
    jc, tc = deployment("kernel")
    jp, tp = shared_params(jc, tc)
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 512, (16,)).astype(np.int32)
    prompts = [np.concatenate([shared, t]) for t in make_prompts([5, 9, 3])]
    ref, got, eng = serve_both(jc, tc, jp, tp, prompts, 6, **ecfg)
    assert eng.chunked == ("chunk_prefill" in ecfg)
    if "page_size" in ecfg:
        assert eng.stats.prefix_hit_tokens > 0
    assert got == ref
