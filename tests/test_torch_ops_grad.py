"""Port vs reference: gradients through the epilogue ops.

``ops.act`` (every epilogue) and ``ops.fused_glu`` under each of the four
schemes: the gradients for x, the weights and the approximant's params
tensor, against ``jax.grad`` through the reference's ``custom_vjp``
(its Pallas kernels run in interpret mode on the CPU, as the reference's
own tests run them). The port's CPU route runs the same
``torch.autograd.Function`` its CUDA route does, with the plain version in
the forward.

Tolerance: each gradient within 2e-5 of the reference, relative to the
largest |grad| of that tensor (measured <= 3e-6: f32 sums in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as JO  # noqa: E402
from repro_torch.kernels import epilogue as tepi  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402

SCHEMES = ("cr_spline", "pwl", "poly", "rational")
EPILOGUES = ("tanh", "sigmoid", "silu", "gelu_tanh", "softplus")
REL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _selection(scheme, act):
    """The same scheme selection for both packages' ops: the CR route by
    table, the others by method."""
    if scheme == "cr_spline":
        return {"table": tepi.table_for(act, 4.0, 32)}, \
            {"table": JO.epi.table_for(act, 4.0, 32)}
    return {"method": scheme}, {"method": scheme}


def _ref_params(scheme, act):
    _, p = JO._resolve_spec_params(act, None, scheme, None, 32, 3, 4.0)
    return np.array(p)


def _close(got, ref):
    got = got.detach().numpy()
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(got - ref).max()) <= REL * scale, (
        float(np.abs(got - ref).max()), scale)


# rational targets tanh only: it has no softplus residual
@pytest.mark.parametrize("scheme,act", [
    (s, a) for s in SCHEMES for a in EPILOGUES
    if (s, a) != ("rational", "softplus")])
def test_act_grads_match_reference(scheme, act):
    rng = np.random.RandomState(0)
    x = rng.uniform(-6, 6, (8, 256)).astype(np.float32)
    g = rng.normal(size=(8, 256)).astype(np.float32)
    p = _ref_params(scheme, act)
    t_sel, j_sel = _selection(scheme, act)

    def jloss(x, p):
        return jnp.sum(JO.act(x, act, params=p, **j_sel) * g)

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(p))
    tx = torch.from_numpy(x).requires_grad_()
    tp = torch.from_numpy(p).requires_grad_()
    y = TO.act(tx, act, params=tp, **t_sel)
    tgx, tgp = torch.autograd.grad((y * torch.from_numpy(g)).sum(), (tx, tp))
    _close(tgx, np.asarray(jgx))
    _close(tgp, np.asarray(jgp))


@pytest.mark.parametrize("act", ("silu", "gelu_tanh"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fused_glu_grads_match_reference(scheme, act):
    rng = np.random.RandomState(1)
    M, K, N = 8, 256, 128
    x = rng.normal(size=(M, K)).astype(np.float32)
    wg = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    wu = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    p = _ref_params(scheme, act)
    t_sel, j_sel = _selection(scheme, act)

    def jloss(x, wg, wu, p):
        return jnp.sum(JO.fused_glu(x, wg, wu, act=act, params=p, **j_sel)
                       * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, wg, wu, p)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wg, wu, p)]
    y = TO.fused_glu(*leaves[:3], act=act, params=leaves[3], **t_sel)
    tgrads = torch.autograd.grad((y * torch.from_numpy(g)).sum(), leaves)
    for got, ref in zip(tgrads, jgrads):
        _close(got, np.asarray(ref))


def test_backward_recomputes_the_plain_version(monkeypatch):
    """One wrapper call in the forward, none in the backward: the
    backward differentiates a recompute of the plain version (f32, "take"
    lookup). The leading-dims reshape stays outside the Function."""
    calls = {"elementwise_2d": 0, "glu_2d": 0, "take": 0}
    real = {n: getattr(tepi, n) for n in ("elementwise_2d", "glu_2d",
                                         "elementwise_2d_plain",
                                         "glu_2d_plain")}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn

    def plain(name):
        def fn(*a, **kw):
            calls["take"] += kw.get("lookup") == "take"
            return real[name](*a, **kw)
        return fn

    for n in ("elementwise_2d", "glu_2d"):
        monkeypatch.setattr(tepi, n, counted(n))
        monkeypatch.setattr(tepi, n + "_plain", plain(n + "_plain"))
    x = torch.randn(2, 3, 64, requires_grad=True)
    w = torch.randn(64, 32, requires_grad=True)
    y = TO.act(x, "silu") + TO.fused_glu(x, w, w * 2).sum(-1, keepdim=True)
    assert tuple(y.shape) == (2, 3, 64)
    y.sum().backward()
    assert calls == {"elementwise_2d": 1, "glu_2d": 1, "take": 2}
    assert x.grad is not None and w.grad is not None


def test_bf16_grads_take_the_input_dtype():
    x = torch.randn(4, 64).to(torch.bfloat16).requires_grad_()
    p = torch.tensor(tepi.table_for("silu", 4.0, 32).windows,
                     dtype=torch.float32, requires_grad=True)
    y = TO.act(x, "silu", params=p,
               table=tepi.table_for("silu", 4.0, 32))
    gx, gp = torch.autograd.grad(y.float().sum(), (x, p))
    assert gx.dtype == torch.bfloat16 and gp.dtype == torch.float32
    assert bool(torch.isfinite(gx.float()).all()) and float(gp.abs().sum()) > 0


@pytest.mark.parametrize("scheme", SCHEMES)
def test_nonfinite_inputs_match_reference(scheme):
    """NaN and +-inf inputs: the reference gives NaN for NaN and the
    saturated value for +-inf; the port's plain version gives the same,
    where an integer cast of NaN used to index out of bounds."""
    x = np.array([[np.nan, 1.0, np.inf, -np.inf, -2.5]], np.float32)
    for act in ("tanh", "silu"):
        t_sel, j_sel = _selection(scheme, act)
        ref = np.asarray(JO.act(jnp.asarray(x), act, **j_sel))
        got = TO.act(torch.from_numpy(x), act, **t_sel).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_window_grad_jumps_at_a_knot_the_knot_grad_does_not():
    """Why the act leaf's gradient is compared per knot on the card
    (``chip_smoke.py`` ``train_f32_vs_cpu``): a CR window leaf holds each
    knot four times, and an input that crosses a knot moves its whole
    contribution from window k's third entry to window k+1's second. Per
    knot (the sum over the entries holding it) the gradient is
    continuous."""
    table = tepi.table_for("tanh", 4.0, 32)
    knot = np.float32(10 * table.period)                    # exactly 1.25
    p = torch.tensor(table.windows, dtype=torch.float32, requires_grad=True)
    idx = (torch.arange(32)[:, None] + torch.arange(4)[None, :]).reshape(-1)

    def grads(x):
        y = TO.act(torch.tensor([[x]], dtype=torch.float32), "tanh",
                   table=table, params=p)
        g, = torch.autograd.grad(y.sum(), p)
        return g, torch.zeros(35, dtype=torch.float64).index_add_(
            0, idx, g.double().reshape(-1))

    below, below_knots = grads(np.nextafter(knot, np.float32(0)))
    at, at_knots = grads(knot)
    assert float(below[9, 2]) == pytest.approx(1.0, abs=1e-5)
    assert float(at[10, 1]) == 1.0 and float(at[9, 2]) == 0.0
    assert float((below - at).abs().max()) > 0.99
    assert float((below_knots - at_knots).abs().max()) < 1e-5


@pytest.mark.parametrize("shape,kshape", [((32, 4), (8, 256)), ((36,), (50,)),
                                          ((8, 4), (3000,)), ((32, 4), (0,)),
                                          ((64, 4), (1024, 3))])
def test_table_lookup_matches_indexing(shape, kshape):
    """``catmull_rom.table_lookup``, the lookup every plain datapath reads
    its table through: the same rows as ``table[k]``, and the gradient of
    ``table[k]`` within 1e-6 relative (f32 sums in another order), the
    same bits on a repeat (no atomics), ragged index counts padded."""
    from repro_torch.core.catmull_rom import table_lookup
    rng = np.random.RandomState(len(kshape))
    table = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                         requires_grad=True)
    k = torch.from_numpy(rng.randint(0, shape[0], kshape))
    g = torch.from_numpy(rng.normal(size=kshape + shape[1:]).astype(
        np.float32))
    y = table_lookup(table, k)
    assert torch.equal(y, table.detach()[k])
    got, = torch.autograd.grad((y * g).sum(), table)
    again, = torch.autograd.grad((table_lookup(table, k) * g).sum(), table)
    ref, = torch.autograd.grad((table[k] * g).sum(), table)
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-6 * max(
        float(ref.abs().max()), 1.0)
