"""The hand-written CUDA kernels against their plain PyTorch versions.

Card-only: every test here is marked ``cuda`` and skips without a CUDA
device (a CUDA kernel has no CPU mode). The file imports neither jax nor
the JAX package, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import epilogue as tepi  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

EPILOGUES = ("tanh", "sigmoid", "silu", "gelu_tanh", "softplus")

pytestmark = pytest.mark.cuda


def rand(shape, scale=6.0, seed=0):
    return np.random.RandomState(seed).uniform(-scale, scale, shape).astype(
        np.float32)


def assert_within_bf16_ulp(got, ref):
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
                     - 7)
    err = (got - ref).abs()
    assert bool((err <= ulp).all()), float(err.max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _table(act, dev):
    table = tepi.table_for(act, 4.0, 32)
    return tepi.TableSpec.of(table), torch.as_tensor(
        table.windows, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("act", EPILOGUES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elementwise_kernel_matches_plain(cuda, act, dtype):
    dt = getattr(torch, dtype)
    spec, p = _table(act, cuda)
    for shape in ((256, 3072), (37, 1000), (1, 3), (3, 5)):
        x = torch.from_numpy(rand(shape, seed=shape[0])).to(cuda, dt)
        n0 = tepi.LAUNCHES["elementwise_2d"]
        y = tepi.elementwise_2d(x, p, spec=spec, act=act)
        torch.cuda.synchronize()
        assert tepi.LAUNCHES["elementwise_2d"] == n0 + 1
        yp = tepi.elementwise_2d_plain(x, p, spec=spec, act=act)
        if dt == torch.float32:
            torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-6)
        else:
            assert_within_bf16_ulp(y, yp)


def test_elementwise_unaligned_input_takes_scalar_path(cuda):
    spec, p = _table("silu", cuda)
    base = torch.from_numpy(rand((1000,), seed=2)).to(cuda)
    x = base[1:].reshape(1, 999)        # contiguous, 4 bytes past alignment
    assert x.data_ptr() % 16 != 0
    y = tepi.elementwise_2d(x, p, spec=spec, act="silu")
    torch.testing.assert_close(y, tepi.elementwise_2d_plain(
        x, p, spec=spec, act="silu"), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", EPILOGUES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_kernel_matches_plain(cuda, act, dtype):
    dt = getattr(torch, dtype)
    spec, p = _table(act, cuda)
    for m, k, n in ((4, 1024, 3072), (37, 300, 130), (130, 512, 256),
                    (1, 9, 5)):
        x = torch.from_numpy(rand((m, k), scale=1.0, seed=m)).to(cuda, dt)
        wg = torch.from_numpy(rand((k, n), scale=0.05, seed=k)).to(cuda, dt)
        wu = torch.from_numpy(rand((k, n), scale=0.05, seed=n)).to(cuda, dt)
        n0 = tepi.LAUNCHES["glu_2d"]
        y = tepi.glu_2d(x, wg, wu, p, spec=spec, act=act)
        torch.cuda.synchronize()
        assert tepi.LAUNCHES["glu_2d"] == n0 + 1
        yp = tepi.glu_2d_plain(x, wg, wu, p, spec=spec, act=act)
        if dt == torch.float32:
            torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-5)
        else:
            torch.testing.assert_close(y.float(), yp.float(), rtol=1e-2,
                                       atol=1e-3)


def test_ops_route_cuda_tensors_to_kernels(cuda):
    x = torch.from_numpy(rand((2, 3, 64), seed=4)).to(cuda)
    w = torch.from_numpy(rand((64, 32), scale=0.1, seed=5)).to(cuda)
    before = dict(tepi.LAUNCHES)
    y = tops.act(x, "gelu_tanh")
    g = tops.fused_glu(x, w, w, act="silu")
    assert tepi.LAUNCHES["elementwise_2d"] == before["elementwise_2d"] + 1
    assert tepi.LAUNCHES["glu_2d"] == before["glu_2d"] + 1
    torch.testing.assert_close(y.cpu(), tops.act(x.cpu(), "gelu_tanh"),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g.cpu(), tops.fused_glu(x.cpu(), w.cpu(),
                                                       w.cpu()),
                               rtol=1e-4, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    spec, p = _table("tanh", cuda)
    with pytest.raises(TypeError):
        tepi.elementwise_2d(torch.zeros(4, 4, dtype=torch.float16,
                                        device=cuda), p, spec=spec)
    with pytest.raises(ValueError):
        tepi.elementwise_2d(torch.zeros(4, 8, device=cuda).t(), p, spec=spec)
    with pytest.raises(ValueError):
        tepi.glu_2d(torch.zeros(4, 8, device=cuda),
                    torch.zeros(8, 4, device=cuda),
                    torch.zeros(8, 4, dtype=torch.bfloat16, device=cuda), p,
                    spec=spec)
