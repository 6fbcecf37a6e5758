"""Port vs reference: the pwl / poly / rational approximant schemes and
the non-approximant engine impls (region / taylor / base2).

Params must be byte-identical to the reference's at every float geometry
the design-space sweep visits (``benchmarks/dse.py::FULL_SWEEP``), for
the tanh target and the widened softplus residual. Blocks are compared
over the full 2^16-point Q2.13 lattice at the reference's own tolerance
(rtol 1e-5, atol 1e-6, ``tests/test_approximant.py``), and each scheme
keeps the design contract there: odd, saturating, monotone.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.dse import FULL_SWEEP  # noqa: E402
from repro.core import activations as JA  # noqa: E402
from repro.core import approximant as JAP  # noqa: E402
from repro.core.fixed_point import representable_grid  # noqa: E402
from repro_torch.core import activations as TA  # noqa: E402
from repro_torch.core import approximant as TAP  # noqa: E402
from repro_torch.kernels import epilogue as tepi  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SCHEMES = ("pwl", "poly", "rational")
# every float geometry the DSE sweeps for the ported schemes
GEOMETRIES = [(s, g) for s, g in FULL_SWEEP if s in SCHEMES]
TARGETS = [(s, g, act) for s, g in GEOMETRIES
           for act in ("tanh", "softplus") if (s, act) != ("rational",
                                                            "softplus")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _id(case):
    return "-".join(str(v) for v in (case[0], *case[1].values(), *case[2:]))


def _specs(scheme, geom, act="tanh"):
    kw = dict(depth=geom.get("depth", 32), degree=geom.get("degree", 3),
              frac_bits=geom.get("frac_bits", 13))
    return JAP.spec_for(scheme, act, **kw), TAP.spec_for(scheme, act, **kw)


def _grid():
    return representable_grid().astype(np.float32)


def test_registry_order_and_constants():
    assert TAP.schemes() == JAP.schemes() == ("cr_spline", "pwl", "poly",
                                              "rational")
    assert TAP.NEWTON_ITERS == JAP.NEWTON_ITERS
    for order in (3, 5, 7, 9):
        for a, b in zip(TAP._pade_from_cf(order), JAP._pade_from_cf(order)):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", TARGETS, ids=_id)
def test_params_byte_identical(case):
    scheme, geom, act = case
    sj, st = _specs(scheme, geom, act)
    assert dataclasses.asdict(sj) == dataclasses.asdict(st)
    target = JAP.target_of(act)
    pj, pt = JAP.params_for(sj, target), TAP.params_for(st, target)
    assert pt.dtype == pj.dtype == np.float32
    assert pt.shape == pj.shape == TAP.get(scheme).params_shape(st)
    assert pt.tobytes() == pj.tobytes()


@pytest.mark.parametrize("case", TARGETS, ids=_id)
def test_block_matches_reference_on_q213_grid(case):
    scheme, geom, act = case
    sj, st = _specs(scheme, geom, act)
    target = JAP.target_of(act)
    x = _grid() if act == "tanh" else 2.0 * np.abs(_grid())
    yj = np.asarray(JAP.block(jnp.asarray(x),
                              jnp.asarray(JAP.params_for(sj, target)), sj))
    yt = TAP.block(torch.from_numpy(x),
                   torch.from_numpy(TAP.params_for(st, target)), st)
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", GEOMETRIES, ids=lambda c: _id(c + ("",)))
def test_design_contract_on_q213_grid(case):
    """Odd, saturating at and beyond x_max, monotone over the lattice, and
    within the reference's 0.03 of tanh, at every swept geometry."""
    scheme, geom = case
    _, spec = _specs(scheme, geom)
    p = torch.from_numpy(TAP.params_for(spec))
    grid = torch.from_numpy(_grid())
    y = TAP.block(grid, p, spec)
    torch.testing.assert_close(TAP.block(-grid, p, spec), -y, rtol=0, atol=0)
    far = torch.linspace(spec.x_max, 4 * spec.x_max, 257)
    sat = torch.full_like(far, float(np.float32(spec.saturation)))
    assert torch.equal(TAP.block(far, p, spec), sat)
    assert torch.equal(TAP.block(-far, p, spec), -sat)
    yo = y[torch.argsort(grid)]
    assert float((yo[1:] - yo[:-1]).min()) >= -1e-6
    assert float(y.abs().max()) <= 1.0 + 1e-6
    err = np.max(np.abs(y.double().numpy() - np.tanh(grid.double().numpy())))
    assert err < 0.03, (scheme, geom, err)


def test_rational_rejects_softplus():
    spec = TAP.spec_for("rational", "softplus")
    with pytest.raises(ValueError, match="tanh only"):
        TAP.params_for(spec, "softplus_res")
    for use_kernel in (False, True):
        eng = TA.ActivationEngine(TA.ActivationConfig(impl="rational",
                                                      use_kernel=use_kernel))
        with pytest.raises(ValueError, match="tanh only"):
            eng.softplus(torch.ones(4, 8))
    with pytest.raises(ValueError, match="tanh only"):
        tops.act(torch.ones(4, 8), "softplus", method="rational")
    with pytest.raises(ValueError, match="tanh only"):
        tops.fused_glu(torch.ones(4, 8), torch.ones(8, 4), torch.ones(8, 4),
                       act="softplus", method="rational")
    # the wrapper refuses it before any route, whatever params it is given
    tanh_spec = TAP.spec_for("rational", "tanh")
    with pytest.raises(ValueError, match="tanh only"):
        tepi.elementwise_2d(torch.ones(2, 3),
                            torch.from_numpy(TAP.params_for(tanh_spec)),
                            spec=tanh_spec, act="softplus")


def test_kernel_wrapper_limits():
    """What the CUDA kernels take is checked in Python before any launch:
    the params' size against the shared-memory limit, the poly degree."""
    x = torch.ones(2, 3)
    big = TAP.spec_for("pwl", depth=1025)
    p = torch.from_numpy(TAP.params_for(big))
    with pytest.raises(ValueError, match="shared-memory"):
        tepi._kernel_args("tanh", big, p, x)
    deg9 = TAP.spec_for("poly", depth=4, degree=9)
    p = torch.from_numpy(TAP.params_for(deg9))
    with pytest.raises(ValueError, match="degree 9"):
        tepi._kernel_args("tanh", deg9, p, x)
    for scheme, shape in (("pwl", (32, 2)), ("poly", (32, 4)),
                          ("rational", (3, 2))):
        spec = TAP.spec_for(scheme)
        p = torch.from_numpy(TAP.params_for(spec))
        assert tuple(p.shape) == shape
        args = tepi._kernel_args("silu", spec, p, x)
        assert args[:3] == (TAP.schemes().index(scheme),) + shape


@pytest.mark.parametrize("impl", ["region", "taylor", "base2"])
@pytest.mark.parametrize("fn", ["tanh", "sigmoid", "silu", "gelu_tanh",
                                "softplus"])
def test_non_approximant_impls_match_reference(impl, fn):
    x = np.random.RandomState(5).uniform(-6, 6, (16, 257)).astype(np.float32)
    for terms in ((2, 3, 4) if impl == "taylor" else (3,)):
        je = JA.ActivationEngine(JA.ActivationConfig(impl=impl,
                                                     taylor_terms=terms))
        te = TA.ActivationEngine(TA.ActivationConfig(impl=impl,
                                                     taylor_terms=terms))
        assert te.act_impl is None
        yj = np.asarray(getattr(je, fn)(jnp.asarray(x)))
        yt = getattr(te, fn)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)


def test_device_params_placed_once():
    spec = TAP.spec_for("poly", depth=8)
    a = TAP.params_on(spec, "tanh", torch.device("cpu"))
    assert a is TAP.params_on(spec, "tanh", torch.device("cpu"))
    assert a.dtype == torch.float32
    assert a.numpy().tobytes() == TAP.params_for(spec).tobytes()
