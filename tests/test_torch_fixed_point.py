"""Port vs reference: the fixed-point primitives (``core/fixed_point.py``).

Everything is int32 in and int32 out, as the reference runs; the wide
products are exact against Python bignums on each of ``fx_mul_shift``'s
three int32 lowerings, and ``fx_dot4``'s partial dots stay int32 (a plain
``torch.sum`` of int32 would widen to int64). Equality is exact
throughout: the arithmetic is integer.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fixed_point as jfp  # noqa: E402
from repro_torch.core import fixed_point as tfp  # noqa: E402

MUL_SHIFT_CASES = [
    (8, 8, 4),          # direct int32 product
    (15, 15, 13),       # direct, flagship widths
    (16, 25, 16),       # 2-piece split (poly Horner widths)
    (16, 16, 10),       # 2-piece split (pwl Q2.16 widths)
    (26, 24, 19),       # 4-piece (rational chain widths)
    (21, 16, 19),       # 4-piece, shift < 2S branch
    (26, 26, 26),       # 4-piece, shift >= 2S branch
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


@pytest.mark.parametrize("a_bits,b_bits,shift", MUL_SHIFT_CASES)
@pytest.mark.parametrize("rounding", ["floor", "nearest"])
def test_fx_mul_shift_exact_vs_bignum_and_reference(a_bits, b_bits, shift,
                                                    rounding):
    rng = np.random.RandomState(a_bits * 1000 + b_bits + shift)
    a = rng.randint(-(2 ** a_bits) + 1, 2 ** a_bits, 4096)
    b = rng.randint(-(2 ** b_bits) + 1, 2 ** b_bits, 4096)
    got = tfp.fx_mul_shift(i32(a), i32(b), shift, rounding=rounding,
                           a_bits=a_bits, b_bits=b_bits)
    assert got.dtype == torch.int32
    prod = a.astype(object) * b.astype(object)   # Python bignums
    if rounding == "nearest":
        prod = prod + (1 << (shift - 1))
    want = np.array([int(p) >> shift for p in prod])
    np.testing.assert_array_equal(got.numpy().astype(object), want)
    ref = jfp.fx_mul_shift(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                           shift, rounding=rounding, a_bits=a_bits,
                           b_bits=b_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fx_mul_shift_edge_magnitudes_and_limits():
    for a_bits, b_bits, shift in ((16, 25, 16), (26, 24, 19)):
        vals_a = np.array([2 ** a_bits - 1, -(2 ** a_bits) + 1, 0, 1, -1])
        vals_b = np.array([2 ** b_bits - 1, -(2 ** b_bits) + 1, 0, 1, -1])
        aa, bb = np.meshgrid(vals_a, vals_b)
        got = tfp.fx_mul_shift(i32(aa.ravel()), i32(bb.ravel()), shift,
                               rounding="floor", a_bits=a_bits,
                               b_bits=b_bits)
        want = np.array([int(x) * int(y) >> shift
                         for x, y in zip(aa.ravel(), bb.ravel())])
        np.testing.assert_array_equal(got.numpy().astype(object), want)
    one = i32([1])
    with pytest.raises(ValueError, match="4-piece"):
        tfp.fx_mul_shift(one, one, 0, a_bits=30, b_bits=30)
    with pytest.raises(ValueError, match="shift >= 0"):
        tfp.fx_mul_shift(one, one, -1)
    with pytest.raises(ValueError, match="rounding"):
        tfp.fx_mul_shift(one, one, 1, rounding="up")


@pytest.mark.parametrize("fmt", [tfp.Q2_13, tfp.QFormat(2, 16)],
                         ids=str)
@pytest.mark.parametrize("rounding", ["floor", "nearest"])
def test_fx_mul_and_fx_add_match_reference(fmt, rounding):
    """At Q2.16 the products pass 2^31 and wrap in int32, as the
    reference's (int32, 64-bit types off) product does."""
    jfmt = jfp.QFormat(fmt.int_bits, fmt.frac_bits)
    rng = np.random.RandomState(fmt.frac_bits)
    a = rng.randint(fmt.min_int, fmt.max_int + 1, 4096).astype(np.int32)
    b = rng.randint(fmt.min_int, fmt.max_int + 1, 4096).astype(np.int32)
    got = tfp.fx_mul(i32(a), i32(b), fmt, rounding)
    ref = jfp.fx_mul(jnp.asarray(a), jnp.asarray(b), jfmt, rounding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if fmt.frac_bits == 16:
        assert (np.abs(a.astype(np.int64) * b) >= 2 ** 31).any()
    got = tfp.fx_add(i32(a), i32(b), fmt)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfp.fx_add(jnp.asarray(a), jnp.asarray(b),
                                           jfmt)))


@pytest.mark.parametrize("frac_bits,extra", [(13, 18), (10, 24), (16, 12)])
@pytest.mark.parametrize("rounding", ["floor", "nearest"])
def test_fx_dot4_three_piece_matches_reference(frac_bits, extra, rounding):
    fmt = tfp.QFormat(2, frac_bits)
    rng = np.random.RandomState(frac_bits + extra)
    p = rng.randint(fmt.min_int, fmt.max_int + 1, (512, 4)).astype(np.int32)
    c = rng.randint(-(2 ** 30), 2 ** 30, (512, 4)).astype(np.int32)
    got = tfp.fx_dot4(i32(p), i32(c), fmt, rounding, extra)
    assert got.dtype == torch.int32 and got.shape == (512,)
    ref = jfp.fx_dot4(jnp.asarray(p), jnp.asarray(c),
                      jfp.QFormat(2, frac_bits), rounding, extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fx_dot4_limb_stack_matches_reference_and_checks_widths():
    fmt = tfp.QFormat(2, 16)
    rng = np.random.RandomState(3)
    p = rng.randint(fmt.min_int, fmt.max_int + 1, (256, 4)).astype(np.int32)
    limbs = [rng.randint(0, 1 << 10, (256, 4)).astype(np.int32)
             for _ in range(4)]
    limbs[-1] = rng.randint(-(1 << 9), 1 << 9, (256, 4)).astype(np.int32)
    got = tfp.fx_dot4(i32(p), tfp.LimbStack(10, tuple(map(i32, limbs))),
                      fmt, extra_shift=24)
    ref = jfp.fx_dot4(jnp.asarray(p), jfp.LimbStack(
        10, tuple(map(jnp.asarray, limbs))), jfp.QFormat(2, 16),
        extra_shift=24)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="overflows int32"):
        tfp.fx_dot4(i32(p), tfp.LimbStack(14, tuple(map(i32, limbs))), fmt)
    with pytest.raises(ValueError, match="top-limb offset"):
        tfp.fx_dot4(i32(p), tfp.LimbStack(10, tuple(map(i32, limbs))), fmt)
    with pytest.raises(ValueError, match="too small"):
        tfp.fx_dot4(i32(p), i32(p), tfp.QFormat(2, 1))


@pytest.mark.parametrize("fmt", [tfp.QFormat(2, 10), tfp.Q2_13,
                                 tfp.QFormat(2, 16)], ids=str)
def test_quantize_and_grid_match_reference_with_nan_and_inf(fmt):
    jfmt = jfp.QFormat(fmt.int_bits, fmt.frac_bits)
    grid = tfp.representable_grid(fmt)
    np.testing.assert_array_equal(grid, jfp.representable_grid(jfmt))
    x = np.concatenate([grid, [np.nan, np.inf, -np.inf, 5.0, -5.0,
                               1.0 / (3 << fmt.frac_bits)]]).astype(np.float32)
    for rounding in ("nearest", "floor"):
        got = tfp.quantize(torch.from_numpy(x), fmt, rounding)
        ref = np.asarray(jfp.quantize(jnp.asarray(x), jfmt, rounding))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert tfp.quantize(torch.tensor([np.nan]), fmt).item() == 0
    np.testing.assert_array_equal(
        tfp.dequantize(tfp.quantize(torch.from_numpy(x), fmt), fmt).numpy(),
        np.asarray(jfp.dequantize(jfp.quantize(jnp.asarray(x), jfmt), jfmt)))
    host = tfp.quantize(grid, fmt)                 # numpy in, numpy out
    assert isinstance(host, np.ndarray) and host.dtype == np.int32
    np.testing.assert_array_equal(host, np.asarray(jfp.quantize(grid, jfmt)))
