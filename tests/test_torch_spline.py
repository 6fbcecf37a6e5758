"""Port vs reference: CR knot tables, float interpolation, the
approximant registry and the Q-format helpers."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import activations as JA  # noqa: E402
from repro.core import approximant as JAP  # noqa: E402
from repro.core import catmull_rom as JCR  # noqa: E402
from repro.core import fixed_point as JFP  # noqa: E402
from repro_torch.core import activations as TA  # noqa: E402
from repro_torch.core import approximant as TAP  # noqa: E402
from repro_torch.core import catmull_rom as TCR  # noqa: E402
from repro_torch.core import fixed_point as TFP  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(n=4001, scale=9.0, seed=0):
    rng = np.random.RandomState(seed)
    x = np.concatenate([np.linspace(-scale, scale, n),
                        rng.uniform(-scale, scale, n),
                        [0.0, -0.0, 4.0, -4.0, 8.0, 3.999, 0.125]])
    return x.astype(np.float32)


@pytest.mark.parametrize("depth", [8, 16, 32, 64])
def test_tanh_table_byte_identical(depth):
    jt, tt = JA.tanh_table(4.0, depth), TA.tanh_table(4.0, depth)
    assert jt.windows.tobytes() == tt.windows.tobytes()
    assert jt.values.tobytes() == tt.values.tobytes()
    assert (jt.x_max, jt.depth, jt.period, jt.saturation) == \
        (tt.x_max, tt.depth, tt.period, tt.saturation)


def test_softplus_table_byte_identical():
    jt = JA.softplus_residual_table(8.0, 64)
    tt = TA.softplus_residual_table(8.0, 64)
    assert jt.windows.tobytes() == tt.windows.tobytes()
    assert jt.saturation == tt.saturation


@pytest.mark.parametrize("odd", [True, False])
@pytest.mark.parametrize("depth", [16, 32, 64])
def test_interpolate_f32(depth, odd):
    table = JA.tanh_table(4.0, depth)
    x = _grid(seed=depth)
    if not odd:
        x = np.abs(x)
    yj = np.asarray(JCR.interpolate(table, jnp.asarray(x), odd=odd))
    yt = TCR.interpolate(TA.tanh_table(4.0, depth), torch.from_numpy(x),
                         odd=odd).numpy()
    assert yt.dtype == np.float32
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-7)


@pytest.mark.parametrize("depth", [16, 32, 64])
def test_interpolate_bf16_exact(depth):
    """bf16 input: both interpolate in bf16 arithmetic (the table is cast
    to the input dtype) and agree bit for bit."""
    x = _grid(seed=depth + 1)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(xj, np.float32), xt.float().numpy())
    yj = np.asarray(JCR.interpolate(JA.tanh_table(4.0, depth), xj), np.float32)
    yt = TCR.interpolate(TA.tanh_table(4.0, depth), xt)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(yt.float().numpy(), yj)


def test_interpolate_pwl_matches():
    x = _grid(seed=5)
    yj = np.asarray(JCR.interpolate_pwl(JA.tanh_table(3.0, 8),
                                        jnp.asarray(x)))
    yt = TCR.interpolate_pwl(TA.tanh_table(3.0, 8),
                             torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-7)


def test_basis_weights_match():
    t = np.linspace(0, 1, 257, dtype=np.float32)[:-1]
    np.testing.assert_allclose(
        TCR.basis_weights(torch.from_numpy(t)).numpy(),
        np.asarray(JCR.basis_weights(jnp.asarray(t))), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(TCR.BASIS, JCR.BASIS)


@pytest.mark.parametrize("act", ["tanh", "softplus"])
@pytest.mark.parametrize("depth", [16, 32])
def test_spec_and_params_identical(act, depth):
    js = JAP.spec_for("cr_spline", act, depth=depth)
    ts = TAP.spec_for("cr_spline", act, depth=depth)
    assert dataclasses_equal(js, ts)
    target = JAP.target_of(act)
    assert target == TAP.target_of(act)
    assert JAP.params_for(js, target).tobytes() == \
        TAP.params_for(ts, target).tobytes()
    assert js.t_bits == ts.t_bits and str(js.qformat) == str(ts.qformat)


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_reference_block_matches():
    spec_j = JAP.spec_for("cr_spline", "tanh")
    spec_t = TAP.spec_for("cr_spline", "tanh")
    x = _grid(seed=9)
    yj = np.asarray(JAP.reference(jnp.asarray(x), spec_j))
    yt = TAP.reference(torch.from_numpy(x), spec_t).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-6)


def test_registry_has_only_the_ported_scheme():
    assert TAP.schemes() == JAP.schemes()
    with pytest.raises(ValueError, match="unknown approximant scheme"):
        TAP.get("cordic")
    # every scheme's fixed ROM is ported (tests/test_torch_fixed_*.py)
    for scheme in TAP.schemes():
        np.testing.assert_array_equal(
            TAP.get(scheme).build_fixed(TAP.spec_for(scheme)),
            np.asarray(JAP.get(scheme).build_fixed(JAP.spec_for(scheme))))


def test_quantize_helpers_match():
    x = _grid(seed=11, scale=5.0)
    qj = np.asarray(JFP.quantize(jnp.asarray(x)))
    qt = TFP.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(TFP.quantize(x.astype(np.float64)),
                                  np.asarray(JFP.quantize(x.astype(np.float64))))
    np.testing.assert_array_equal(TFP.dequantize(qt).numpy(),
                                  np.asarray(JFP.dequantize(jnp.asarray(qj))))
    big = torch.tensor([-10 ** 6, 0, 10 ** 6], dtype=torch.int32)
    np.testing.assert_array_equal(
        TFP.sat(big).numpy(), np.asarray(JFP.sat(jnp.asarray(big.numpy()))))
    assert (TFP.Q2_13.scale, TFP.Q2_13.max_int, TFP.GUARD_BITS) == \
        (JFP.Q2_13.scale, JFP.Q2_13.max_int, JFP.GUARD_BITS)
