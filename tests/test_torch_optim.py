"""Port vs reference: AdamW, the cosine schedule, global-norm clipping and
int8 error-feedback compression, on random nested trees given to both
packages as numpy.

Tolerances: f32 elementwise results within 1e-6 relative (measured:
equal, or a few ulp where the two libraries' cos / pow differ); int8
compression bitwise (the same f32 max, one IEEE division and round-half-
to-even in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compress as JC  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compress as TC  # noqa: E402

RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"embed": (rng.normal(size=(64, 16)) * scale).astype(np.float32),
            "blocks": {"w": (rng.normal(size=(3, 16, 8)) * scale)
                       .astype(np.float32),
                       "scale": (rng.normal(size=(3, 8)) * scale)
                       .astype(np.float32)},
            "act": {"cr-d32": (rng.normal(size=(32, 4)) * scale)
                    .astype(np.float32)}}


def to_torch(tree):
    return TA.tree_map(lambda a: torch.tensor(a), tree)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_tree_close(got, ref, rtol=RTOL, atol=0.0, exact=False):
    got_l = TA.tree_leaves(got)
    ref_l = jax.tree.leaves(ref)
    assert len(got_l) == len(ref_l)
    for g, r in zip(got_l, ref_l):
        g = g.numpy()
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        if exact:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


def test_tree_leaves_follow_jax_order():
    tree = random_tree(0)
    for a, b in zip(TA.tree_leaves(to_torch(tree)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("cfg", [
    JA.AdamWConfig(),
    JA.AdamWConfig(lr_peak=2e-2, warmup_steps=5, decay_steps=100),
    JA.AdamWConfig(lr_peak=1e-3, lr_min=0.0, warmup_steps=0,
                   decay_steps=0)], ids=["default", "short", "no-warmup"])
def test_cosine_schedule_matches_reference(cfg):
    tcfg = TA.AdamWConfig(**{f: getattr(cfg, f)
                             for f in cfg.__dataclass_fields__})
    for step in (0, 1, 2, 4, 5, 6, 50, 99, 100, 101, 5000, 9999, 10000,
                 10001, 50000):
        ref = float(JA.cosine_schedule(cfg, jnp.int32(step)))
        got = TA.cosine_schedule(tcfg, step, "cpu")
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), ref, rtol=RTOL, err_msg=step)
        # a 0-d tensor step gives the same value
        assert float(TA.cosine_schedule(
            tcfg, torch.tensor(step, dtype=torch.int32))) == float(got)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (1e-3, 1.0),
                                            (10.0, 0.5)])
def test_global_norm_and_clip_match_reference(scale, max_norm):
    tree = random_tree(1, scale)
    jg, jn = JA.clip_by_global_norm(to_jax(tree), max_norm)
    tg, tn = TA.clip_by_global_norm(to_torch(tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    np.testing.assert_allclose(float(TA.global_norm(to_torch(tree))),
                               float(JA.global_norm(to_jax(tree))), rtol=RTOL)
    assert_tree_close(tg, jg)


def test_adamw_update_matches_reference():
    params = random_tree(2)
    grads = random_tree(3, 0.1)
    m = random_tree(4, 0.01)
    v = TA.tree_map(lambda a: np.abs(a), random_tree(5, 0.001))
    cfg = JA.AdamWConfig()
    tcfg = TA.AdamWConfig()
    jstate = {"m": to_jax(m), "v": to_jax(v), "count": jnp.int32(3)}
    tstate = {"m": to_torch(m), "v": to_torch(v),
              "count": torch.tensor(3, dtype=torch.int32)}
    lr = 1e-3
    jp, js = JA.adamw_update(to_jax(grads), jstate, to_jax(params), cfg,
                             jnp.float32(lr))
    tp, ts = TA.adamw_update(to_torch(grads), tstate, to_torch(params), tcfg,
                             torch.tensor(lr, dtype=torch.float32))
    assert_tree_close(tp, jp, atol=1e-9)
    assert_tree_close(ts["m"], js["m"])
    assert_tree_close(ts["v"], js["v"])
    assert int(ts["count"]) == int(js["count"]) == 4
    assert ts["count"].dtype == torch.int32


def test_init_state_layout():
    params = to_torch(random_tree(6))
    st = TA.init_state(params)
    assert set(st) == {"m", "v", "count"}
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    for leaf in TA.tree_leaves(st["m"]) + TA.tree_leaves(st["v"]):
        assert not bool(leaf.any())


@pytest.mark.parametrize("seed", [7, 8])
def test_compress_grads_matches_reference_bitwise(seed):
    grads = random_tree(seed, 0.05)
    err = random_tree(seed + 100, 1e-4)
    jg, je = JC.compress_grads(to_jax(grads), to_jax(err))
    tg, te = TC.compress_grads(to_torch(grads), to_torch(err))
    assert_tree_close(tg, jg, exact=True)
    assert_tree_close(te, je, exact=True)
    # error feedback: payload + new error == grad + old error (f32)
    for g, e, q, ne in zip(*(TA.tree_leaves(t) for t in
                            (to_torch(grads), to_torch(err), tg, te))):
        torch.testing.assert_close(q + ne, g + e, rtol=0, atol=1e-7)


def test_compress_keeps_grad_dtype_and_zero_error_init():
    grads = {"w": torch.randn(8, 8).to(torch.bfloat16)}
    err = TC.init_error(grads)
    assert err["w"].dtype == torch.float32 and not bool(err["w"].any())
    q, e = TC.compress_grads(grads, err)
    assert q["w"].dtype == torch.bfloat16 and e["w"].dtype == torch.float32
    assert len(torch.unique(q["w"].float() / (
        grads["w"].float().abs().max() / 127.0))) <= 255
