"""The port's roofline (``repro_torch/analysis/roofline.py``) against the
reference's (``repro/analysis/roofline.py``).

``model_flops_for`` equals the reference's exactly for every assigned arch
and shape cell. ``analyze`` keeps the reference's fields, ``terms()`` and
formulas (bottleneck: the largest term; ``mfu_bound`` = the model's FLOPs a
device at the bf16 peak over the dominant term) with the H100 SXM's
constants: compute summed over FLOP classes at their own peaks, the
collectives summed over mesh axes at each axis' link rate (NVLink within
an 8-card node, the network across nodes). No TPU constant remains.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import hlo_cost as H  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import shapes as TSH  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Mesh:
    """A stand-in mesh: axis name -> size, ranks laid out row-major."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


@pytest.mark.parametrize("arch", sorted(TR.assigned_archs()))
def test_model_flops_equal_the_reference(arch):
    from repro.analysis import roofline as jrl
    from repro.configs import registry as JR
    from repro.launch import shapes as JSH
    for name, cell in JSH.SHAPES.items():
        got = rl.model_flops_for(TR.get(arch), TSH.SHAPES[name])
        assert got == jrl.model_flops_for(JR.get(arch), cell), (arch, name)


def test_h100_constants_and_no_tpu_constant():
    assert (rl.PEAK_FLOPS_BF16, rl.PEAK_FLOPS_F32, rl.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    assert (rl.NVLINK_BW, rl.NETWORK_BW, rl.CARDS_PER_NODE) == \
        (450e9, 50e9, 8)
    assert rl.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                             "float32": 67e12, "vector": 67e12}
    for name in ("ICI_BW", "PEAK_FLOPS_V5E"):
        assert not hasattr(rl, name)
    text = open(rl.__file__).read()
    for tpu in ("197e12", "819e9", "v5e", "ICI"):
        assert tpu not in text


def test_link_bandwidth_by_node():
    # (data, model) = (16, 16): model's 16 ranks span two nodes, data's
    # stride of 16 crosses them
    big = Mesh(data=16, model=16)
    assert rl.link_bandwidth(big, "model") == rl.NETWORK_BW
    assert rl.link_bandwidth(big, "data") == rl.NETWORK_BW
    # (2, 4): model's ranks 0-3 and data's 0, 4 all sit in node 0
    node = Mesh(data=2, model=4)
    assert rl.link_bandwidth(node, "model") == rl.NVLINK_BW
    assert rl.link_bandwidth(node, "data") == rl.NVLINK_BW
    pods = Mesh(pod=2, data=16, model=16)
    assert rl.link_bandwidth(pods, "pod") == rl.NETWORK_BW
    assert rl.link_bandwidth(Mesh(data=1, model=8), "model") == rl.NVLINK_BW


def _totals():
    t = H.CostTotals()
    t.add_flops("bfloat16", 989 * 10**12)
    t.add_flops("float32", 67 * 10**12)
    t.add_flops("vector", 67 * 10**11)
    t.bytes = 335 * 10**10
    t.add_collective("model", "all-reduce", 3, 450 * 10**9)
    t.add_collective("data", "all-gather", 2, 50 * 10**9)
    return t


def test_analyze_terms_and_formulas():
    t = _totals()
    node = Mesh(data=2, model=4)
    r = rl.analyze(t, n_devices=8, model_flops=8 * 500e12, mesh=node)
    assert r.compute_s == pytest.approx(1.0 + 1.0 + 0.1)
    # the collectives' result bytes are HBM bytes too (the reference's)
    assert r.memory_s == pytest.approx((3.35e12 + 0.5e12) / 3.35e12)
    assert r.collective_s_by_axis == {"model": pytest.approx(1.0),
                                      "data": pytest.approx(50 / 450)}
    assert r.collective_s == pytest.approx(1.0 + 50 / 450)
    assert r.bottleneck == "compute"
    assert r.terms() == {"compute_s": r.compute_s, "memory_s": r.memory_s,
                         "collective_s": r.collective_s,
                         "bottleneck": "compute"}
    assert r.model_flops_per_device == 500e12
    assert r.useful_ratio == pytest.approx(500e12 / t.flops)
    assert r.mfu_bound == pytest.approx((500e12 / 989e12) / 2.1)
    assert r.collectives.total_bytes == 500 * 10**9
    assert r.collectives.count_by_kind == {"all-reduce": 3, "all-gather": 2}
    # across nodes the same bytes take the network's rate
    far = rl.analyze(t, n_devices=256, model_flops=0.0,
                     mesh=Mesh(data=16, model=16))
    assert far.collective_s == pytest.approx(500e9 / 50e9)
    assert far.bottleneck == "collective"
    assert far.mfu_bound == 0.0
    fields = {f.name for f in dataclasses.fields(rl.Roofline)}
    assert {"flops", "hbm_bytes", "collective_bytes", "compute_s",
            "memory_s", "collective_s", "bottleneck", "model_flops",
            "model_flops_per_device", "useful_ratio", "mfu_bound",
            "collectives"} <= fields


def test_memory_bound_bottleneck():
    t = H.CostTotals()
    t.add_flops("bfloat16", 10**9)
    t.bytes = 10**12
    r = rl.analyze(t, n_devices=1, model_flops=10**9)
    assert r.bottleneck == "memory"
    assert r.mfu_bound == pytest.approx((1e9 / 989e12) / (1e12 / 3.35e12))
