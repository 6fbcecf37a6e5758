"""Port vs reference: the dense archs beyond qwen3-0.6b (olmo-1b's
non-parametric LayerNorm, qwen2.5-3b's QKV bias and extreme GQA ratio,
yi-34b's llama layout), a logit softcap, a non-GLU MLP and a sliding
window, on the reference's own weights.

The reference's params cross over as numpy through ``params_from_numpy``;
both packages compute forward logits, ragged-prefill logits and cache,
and decode steps on the same tokens, under the plain config, the fused
deployment (``fused_of``: ``glu_2d`` on every FFN) and the kernelized
engine (``elementwise_2d`` on every FFN activation; on the CPU both are
their plain versions). f32 compute, logits within 1e-4 absolute (as
``tests/test_torch_model.py``); bf16 within 0.1.
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
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402

DENSE = ("olmo-1b", "qwen2.5-3b", "yi-34b")
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


def deployment(arch, dep, dtype="float32", **over):
    """(reference config, port config) of one deployment: ``plain``,
    ``fused`` (glu_2d on every FFN) or ``kernel`` (elementwise_2d on every
    nonlinearity of the engine)."""
    jc = JR.get(arch, smoke=True, compute_dtype=dtype, **over)
    tc = TR.get(arch, smoke=True, compute_dtype=dtype, **over)
    if dep == "fused":
        return j_fused_of(jc), fused_of(tc)
    if dep == "kernel":
        return (j_act_impl_of(jc, "cr_spline", use_kernel=True),
                act_impl_of(tc, "cr_spline", use_kernel=True))
    return jc, tc


def shared_params(jc, tc, seed=0):
    jp, _ = JM.materialize_params(jc, seed=seed)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jp, tp


def check_forward_prefill(jc, tc, jp, tp, tol, S=21):
    toks = np.random.RandomState(0).randint(0, 512, (2, S)).astype(np.int32)
    jl = JM.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jc,
                       JS.make_engine(jc))
    tl = TM.forward_fn(tp, {"tokens": torch.from_numpy(toks)}, tc,
                       TS.make_engine(tc))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)

    lens = np.array([S, S - 8], np.int32)
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
    np.testing.assert_allclose(tcache["layers"]["v"].float().numpy(),
                               np.asarray(jcache["layers"]["v"], np.float32),
                               rtol=0, atol=tol)


def check_decode(jc, tc, jp, tp, tol, S=12, capacity=10, steps=4):
    """Lockstep prefill, then greedy decode steps through a ring that
    wraps: logits agree at every step."""
    toks = np.random.RandomState(1).randint(0, 512, (2, S)).astype(np.int32)
    je, te = JS.make_engine(jc), TS.make_engine(tc)
    jl, jcache = JM.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jc, je,
                               capacity=capacity)
    tl, tcache = TM.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, tc,
                               te, capacity=capacity)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jcache = JM.decode_fn(jp, {"tokens": jnp.asarray(nxt)}, jcache,
                                  jc, je)
        tl, tcache = TM.decode_fn(tp, {"tokens": torch.from_numpy(nxt)},
                                  tcache, tc, te)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(tcache["k_pos"].numpy(),
                                  np.asarray(jcache["k_pos"]))


@pytest.mark.parametrize("dep", ["plain", "fused", "kernel"])
@pytest.mark.parametrize("arch", DENSE)
def test_arch_logits_and_decode_match_reference(arch, dep):
    jc, tc = deployment(arch, dep)
    jp, tp = shared_params(jc, tc)
    check_forward_prefill(jc, tc, jp, tp, TOL["float32"])
    check_decode(jc, tc, jp, tp, TOL["float32"])


@pytest.mark.parametrize("arch", DENSE)
def test_arch_bf16_logits_match_reference(arch):
    """bf16 compute, fused: the frameworks round bf16 at other places, so
    only the order of magnitude is held (0.1 on logits of ~4)."""
    jc, tc = deployment(arch, "fused", "bfloat16")
    jp, tp = shared_params(jc, tc)
    check_forward_prefill(jc, tc, jp, tp, TOL["bfloat16"])


@pytest.mark.parametrize("arch", DENSE)
def test_arch_param_tree_matches_reference(arch):
    """Same key paths, shapes and f32 leaves as the reference's tree
    (olmo-1b: no norm scales; qwen2.5-3b: the QKV biases)."""
    cfg = TR.get(arch, smoke=True)
    tp = TM.materialize_params(cfg, seed=0, device="cpu")
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
    assert ("['blocks']['attn']['bq']" in tflat) == (arch == "qwen2.5-3b")
    assert ("['blocks']['ln1']['scale']" in tflat) == (arch != "olmo-1b")


@pytest.mark.parametrize("case", ["softcap", "gelu_no_glu", "sliding_window"])
@pytest.mark.parametrize("dep", ["plain", "kernel"])
def test_block_options_match_reference(case, dep):
    """Options no full config of the port sets together: a logit softcap
    (the engine's tanh on every attention score: under ``kernel`` one
    elementwise_2d launch per score chunk), a non-GLU MLP with gelu_tanh,
    and a sliding window that decode runs past (window 8, 12 prompt
    tokens, a ring of 8)."""
    over = {"softcap": dict(logit_softcap=30.0),
            "gelu_no_glu": dict(glu=False, mlp_act="gelu_tanh"),
            "sliding_window": dict(sliding_window=8)}[case]
    jc, tc = deployment("olmo-1b", dep, **over)
    jp, tp = shared_params(jc, tc)
    check_forward_prefill(jc, tc, jp, tp, TOL["float32"])
    check_decode(jc, tc, jp, tp, TOL["float32"],
                 capacity=8 if case == "sliding_window" else 10, steps=6)


def serve_both(jc, tc, jp, tp, lens=(9, 17, 30, 12), gen=6):
    """Greedy tokens of the reference's and the port's ServeEngine (paged,
    both defaults) on the same requests: (reference, port)."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n in lens]
    kw = dict(slots=2, chunk=4, max_prompt_len=32, max_len=32 + gen)
    jeng = JServeEngine(jc, jp, JEngineConfig(**kw))
    teng = ServeEngine(tc, tp, EngineConfig(**kw), device="cpu")
    assert teng.paged
    for p in prompts:
        jeng.submit(p, max_new=gen)
        teng.submit(p, max_new=gen)
    return [c.tokens for c in jeng.run()], [c.tokens for c in teng.run()]


@pytest.mark.parametrize("arch", DENSE)
def test_serve_tokens_match_reference(arch):
    jc, tc = deployment(arch, "fused")
    jp, tp = shared_params(jc, tc)
    ref, got = serve_both(jc, tc, jp, tp)
    assert got == ref


@pytest.mark.parametrize("with_smoke", [False, True])
def test_register_resolves_like_reference(monkeypatch, with_smoke):
    """A config registered under a new id resolves as in the reference:
    ``get`` returns the full config, or under ``smoke=True`` the smoke one
    (the full one when none was registered), with overrides applied; an
    id registered dynamically bypasses the module lookup."""
    for reg in (JR, TR):
        monkeypatch.setattr(reg, "_DYNAMIC", {})
        full, small = reg.get("olmo-1b"), reg.get("olmo-1b", smoke=True)
        reg.register("my-olmo", full, small if with_smoke else None)
        for smoke in (False, True):
            want = small if smoke and with_smoke else full
            assert reg.get("my-olmo", smoke=smoke) == want
            assert reg.get("my-olmo", smoke=smoke, n_layers=3) == \
                dataclasses.replace(want, n_layers=3)
    for smoke in (False, True):
        j = JR.get("my-olmo", smoke=smoke, n_layers=3)
        t = TR.get("my-olmo", smoke=smoke, n_layers=3)
        assert (t.name, t.n_layers, t.d_model, t.d_ff, t.vocab_size) == \
            (j.name, j.n_layers, j.d_model, j.d_ff, j.vocab_size)
    # an id neither registered nor a config module raises, as in the
    # reference
    for reg in (JR, TR):
        with pytest.raises(ModuleNotFoundError):
            reg.get("no-such-arch")
