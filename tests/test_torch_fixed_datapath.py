"""Port vs reference: every scheme's bit-accurate integer datapath and
the ``<scheme>_fixed`` activation engines.

``fixed_block`` of each scheme is held BIT-identical to the reference's
over the full Q2.10, Q2.13 and Q2.16 lattices (2^13 to 2^19 points),
CR's ``interpolate_fixed`` at the paper's depths 8, 16, 32 and 64 (the
limb-MAC and the wrapped 31-bit-lattice geometries), the ROMs and their
requantization bitwise, the engines bitwise on every nonlinearity with
NaN and ±inf in the input, bf16 included (``gelu_tanh`` rounds its
constants to x's dtype, as jnp does with a Python scalar), and the
straight-through gradients against
jax.grad through the reference's ``custom_jvp``: 1e-6 relative to the
largest |grad| in x (measured: the unbound routes equal, the bound ones
<= 2.2e-7) and 5e-6 in the params (<= 3.2e-6; the per-knot sums run in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import activations as jact  # noqa: E402
from repro.core import approximant as japx  # noqa: E402
from repro.core import catmull_rom as jcr  # noqa: E402
from repro.core import fixed_point as jfp  # noqa: E402
from repro_torch.core import activations as tact  # noqa: E402
from repro_torch.core import approximant as tapx  # noqa: E402
from repro_torch.core import catmull_rom as tcr  # noqa: E402
from repro_torch.core import fixed_point as tfp  # noqa: E402

# each scheme's deployed fixed geometry (the reference's own FIXED_GEOMS)
FIXED_GEOMS = {
    "cr_spline": dict(depth=32, degree=3),
    "pwl": dict(depth=32, degree=3),
    "poly": dict(depth=8, degree=3),
    "rational": dict(depth=32, degree=5),
}
IMPLS = ("cr_fixed", "cr_spline_fixed", "pwl_fixed", "poly_fixed",
         "rational_fixed")
FUNCS = ("tanh", "sigmoid", "silu", "gelu_tanh", "softplus")
REL_GX, REL_GP = 1e-6, 5e-6


def specs(scheme, frac_bits=13, **over):
    geom = {**FIXED_GEOMS[scheme], **over}
    kw = dict(depth=geom["depth"], degree=geom["degree"], int_bits=2,
              frac_bits=frac_bits)
    return (japx.spec_for(scheme, "tanh", **kw),
            tapx.spec_for(scheme, "tanh", **kw))


def cfg_kw(impl, frac_bits=13):
    scheme = tact.fixed_scheme_of(impl)
    return dict(impl=impl, depth=FIXED_GEOMS[scheme]["depth"],
                degree=FIXED_GEOMS[scheme]["degree"], frac_bits=frac_bits)


def with_specials(x):
    x = np.array(x, np.float32)
    x.reshape(-1)[:5] = [np.nan, np.inf, -np.inf, 0.0, -0.0]
    return x


@pytest.mark.parametrize("frac_bits", [10, 13, 16])
@pytest.mark.parametrize("scheme", sorted(FIXED_GEOMS))
def test_fixed_block_bit_identical_over_the_full_lattice(scheme, frac_bits):
    js, ts = specs(scheme, frac_bits)
    rom = tapx.fixed_params_for(ts, "tanh")
    jrom = japx.fixed_params_for(js, "tanh")
    assert rom.dtype == np.int32
    np.testing.assert_array_equal(rom, np.asarray(jrom))
    fmt = tfp.QFormat(2, frac_bits)
    grid = tfp.representable_grid(fmt)
    xq = torch.from_numpy(tfp.quantize(grid, fmt))
    got = tapx.fixed_block(xq, torch.from_numpy(rom), ts)
    assert got.dtype == torch.int32 and got.shape == xq.shape
    ref = japx.fixed_block(jfp.quantize(grid, jfp.QFormat(2, frac_bits)),
                           jnp.asarray(jrom), js)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("depth", [8, 16, 32, 64])
def test_cr_interpolate_fixed_at_every_paper_depth(depth):
    """Depths 8 and 16 take the limb MAC; depth 32 is the 31-bit lattice
    whose w1(t=0) wraps to -2^31 (the knot-hit bypass makes it right)."""
    jt = jcr.build_fixed_table(np.tanh, 4.0, depth)
    tt = tcr.build_fixed_table(np.tanh, 4.0, depth)
    assert (tt.t_bits, tt.sat_q, tt.fmt) == (jt.t_bits, jt.sat_q, tfp.Q2_13)
    np.testing.assert_array_equal(tt.windows_q, np.asarray(jt.windows_q))
    grid = tfp.representable_grid()
    got = tcr.interpolate_fixed(tt, torch.from_numpy(tfp.quantize(grid)))
    ref = jcr.interpolate_fixed(jt, jfp.quantize(grid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    w = tcr.basis_weights_fixed(torch.arange(1 << tt.t_bits), tt)
    jw = jcr.basis_weights_fixed(jnp.arange(1 << jt.t_bits), jt)
    if isinstance(w, tfp.LimbStack):
        assert depth in (8, 16) and w.s == jw.s == tcr.WIDE_LIMB_BITS
        for a, b in zip(w.limbs, jw.limbs, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        if depth == 32:
            assert int(w[0, 1]) == -(2 ** 31) == tcr._wrap_i32(2 << 30)


@pytest.mark.parametrize("frac_bits", [10, 13, 16])
@pytest.mark.parametrize("scheme", sorted(FIXED_GEOMS))
def test_requantize_of_built_params_is_the_rom(scheme, frac_bits):
    js, ts = specs(scheme, frac_bits)
    got = tapx.requantize(torch.from_numpy(tapx.params_for(ts, "tanh")), ts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tapx.fixed_params_for(ts))
    moved = tapx.params_for(ts, "tanh") * np.float32(0.97)
    np.testing.assert_array_equal(
        tapx.requantize(torch.from_numpy(moved), ts).numpy(),
        np.asarray(japx.requantize(jnp.asarray(moved), js)))


@pytest.mark.parametrize("scheme", sorted(FIXED_GEOMS))
def test_fixed_block_nan_and_inf_as_the_reference(scheme):
    js, ts = specs(scheme)
    x = with_specials(np.linspace(-5, 5, 64))
    xq = tfp.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(),
                                  np.asarray(jfp.quantize(jnp.asarray(x))))
    assert xq[:3].tolist() == [0, tfp.Q2_13.max_int, tfp.Q2_13.min_int]
    got = tapx.fixed_block(xq, tapx.fixed_params_for(ts), ts)
    ref = japx.fixed_block(jfp.quantize(jnp.asarray(x)),
                           jnp.asarray(japx.fixed_params_for(js)), js)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("frac_bits", [13, 16])
@pytest.mark.parametrize("impl", IMPLS)
def test_engine_every_nonlinearity_bitwise(impl, frac_bits):
    kw = cfg_kw(impl, frac_bits)
    te = tact.ActivationEngine(tact.ActivationConfig(**kw))
    je = jact.ActivationEngine(jact.ActivationConfig(**kw))
    assert te.act_impl is None          # not kernelizable: no kernel path
    x = with_specials(np.random.RandomState(5).uniform(-6, 6, (33, 65)))
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dtype)
        xj = jnp.asarray(xt.float().numpy(), jdt)
        for fn in FUNCS:
            got = getattr(te, fn)(xt)
            assert got.dtype == dtype, fn
            ref = np.asarray(getattr(je, fn)(xj), np.float32)
            np.testing.assert_array_equal(got.float().numpy(), ref,
                                          err_msg=f"{impl} {fn} {dtype}")


@pytest.mark.parametrize("impl", IMPLS)
def test_bound_engine_requantizes_its_leaf(impl):
    """The model's route: ``bind`` to the f32 act leaf requantizes it on
    every call. At the built leaf it equals the unbound engine; at a
    moved leaf it equals the reference bound to the same leaf."""
    kw = cfg_kw(impl)
    tcfg, jcfg = tact.ActivationConfig(**kw), jact.ActivationConfig(**kw)
    leaf = tact.init_act_params([tcfg])[tcfg.tag()]
    np.testing.assert_array_equal(
        leaf, jact.init_act_params([jcfg])[jcfg.tag()])
    x = with_specials(np.random.RandomState(7).uniform(-5, 5, (16, 40)))
    te, je = tact.ActivationEngine(tcfg), jact.ActivationEngine(jcfg)
    tb = te.bind({tcfg.tag(): torch.from_numpy(leaf)})
    assert tb is not te
    np.testing.assert_array_equal(tb.tanh(torch.from_numpy(x)).numpy(),
                                  te.tanh(torch.from_numpy(x)).numpy())
    moved = leaf * np.float32(1.01)
    got = te.bind({tcfg.tag(): torch.from_numpy(moved)}).silu(
        torch.from_numpy(x))
    ref = je.bind({jcfg.tag(): jnp.asarray(moved)}).silu(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got.astype(np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("impl", IMPLS)
def test_straight_through_grads_match_reference_jvp(impl):
    kw = cfg_kw(impl)
    tcfg, jcfg = tact.ActivationConfig(**kw), jact.ActivationConfig(**kw)
    x = np.random.RandomState(6).uniform(-3, 3, (24, 48)).astype(np.float32)
    wt = np.cos(np.arange(x.size, dtype=np.float32)).reshape(x.shape)
    # unbound: gradient in x through each nonlinearity but softplus (its
    # residual is the float spline, no straight-through)
    je, te = jact.ActivationEngine(jcfg), tact.ActivationEngine(tcfg)
    for fn in ("tanh", "silu", "gelu_tanh"):
        gj = jax.grad(lambda v: (getattr(je, fn)(v) * wt).sum())(
            jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        (getattr(te, fn)(xt) * torch.from_numpy(wt)).sum().backward()
        assert np.isfinite(xt.grad.numpy()).all()
        assert _rel_err(xt.grad.numpy(), gj) <= REL_GX, (impl, fn)
    # bound: gradient in x and in the params (quantization-aware training)
    leaf = tact.init_act_params([tcfg])[tcfg.tag()]
    gxj, gpj = jax.grad(
        lambda v, q: (jact.ActivationEngine(jcfg, act_params=q).sigmoid(v)
                      * wt).sum(), argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(leaf))
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(leaf).requires_grad_()
    (tact.ActivationEngine(tcfg, act_params=pt).sigmoid(xt)
     * torch.from_numpy(wt)).sum().backward()
    assert _rel_err(xt.grad.numpy(), gxj) <= REL_GX, impl
    assert _rel_err(pt.grad.numpy(), gpj) <= REL_GP, impl
    assert np.abs(pt.grad.numpy()).max() > 0


def test_fixed_engine_contracts():
    with pytest.raises(ValueError, match="no kernel lowering"):
        tact.ActivationEngine(tact.ActivationConfig(impl="pwl_fixed",
                                                    use_kernel=True))
    assert tact.fixed_scheme_of("cr_fixed") == "cr_spline"
    assert tact.fixed_scheme_of("bogus_fixed") is None
    cfg = tact.ActivationConfig(impl="pwl_fixed", frac_bits=10)
    assert cfg.tag() == jact.ActivationConfig(impl="pwl_fixed",
                                              frac_bits=10).tag()
    x = torch.linspace(-5, 5, 2001)
    for fb in (13, 10):   # the cr_fixed alias at the default and a swept Q
        a = tact.ActivationEngine(tact.ActivationConfig(impl="cr_fixed",
                                                        frac_bits=fb))
        b = tact.ActivationEngine(tact.ActivationConfig(
            impl="cr_spline_fixed", frac_bits=fb))
        assert torch.equal(a.tanh(x), b.tanh(x))
    # the ROM is copied to a device once and then reused
    _, ts = specs("pwl")
    assert tapx.fixed_params_on(ts, "tanh", torch.device("cpu")) is \
        tapx.fixed_params_on(ts, "tanh", torch.device("cpu"))
