"""The benchmark's frozen yardstick equals the program's own arithmetic on
the same shapes: the peaks, the model FLOPs behind an MFU, the parameter
counts, and the two kernels' operations and bytes."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from benchlib import roofline, spec

HERE = Path(__file__).resolve().parent
CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))


@dataclasses.dataclass
class Shape:
    kind: str
    global_batch: int
    seq_len: int


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_peaks_are_the_programs():
    from repro_torch.analysis import roofline as prog
    assert roofline.PEAK_FLOPS_BF16 == prog.PEAK_FLOPS_BF16
    assert roofline.PEAK_FLOPS_F32 == prog.PEAK_FLOPS_F32
    assert roofline.HBM_BW == prog.HBM_BW


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kind,batch,seq", [("train", 8, 2048),
                                            ("prefill", 3, 1536),
                                            ("decode", 128, 1)])
def test_model_flops_equal_the_programs(name, kind, batch, seq):
    from repro_torch.analysis import roofline as prog
    conf = _config(name)
    cfg = spec.program_config(conf)
    want = prog.model_flops_for(cfg, Shape(kind, batch, seq))
    tokens = batch * seq
    got = roofline.model_flops(conf["model"], tokens,
                               "train" if kind == "train" else "forward")
    assert got == want
    assert roofline.param_count(conf["model"]) == cfg.param_count()
    assert roofline.active_param_count(conf["model"]) == \
        cfg.active_param_count()


@pytest.mark.parametrize("m,k,n,dtype", [(16384, 2048, 8192, torch.bfloat16),
                                         (128, 2048, 8192, torch.bfloat16),
                                         (2, 1024, 3072, torch.float32)])
def test_glu_work_equals_the_programs(m, k, n, dtype):
    from repro_torch.kernels import epilogue as epi
    spec_ = epi._spec_for_epilogue("silu", "cr_spline", 4.0, 32)
    params = torch.empty((32, 4), device="meta")
    x = torch.empty((m, k), dtype=dtype, device="meta")
    wg = torch.empty((k, n), dtype=dtype, device="meta")
    flops, nbytes = epi.glu_work(x, wg, params, spec_, "silu")
    tf, vf, nb = roofline.glu_work(m, k, n, x.element_size(), "silu", 128)
    assert nb == nbytes
    assert vf == flops["vector"]
    assert tf == flops[str(dtype).removeprefix("torch.")]


@pytest.mark.parametrize("rows,cols,dtype", [(128, 16384, torch.bfloat16),
                                             (4, 8192, torch.float32)])
def test_elementwise_work_equals_the_programs(rows, cols, dtype):
    from repro_torch.kernels import epilogue as epi
    spec_ = epi._spec_for_epilogue("silu", "cr_spline", 4.0, 32)
    params = torch.empty((32, 4), device="meta")
    x = torch.empty((rows, cols), dtype=dtype, device="meta")
    flops, nbytes = epi.elementwise_work(x, params, spec_, "silu")
    _, vf, nb = roofline.elementwise_work(rows * cols, x.element_size(),
                                          "silu", 128)
    assert (vf, nb) == (flops["vector"], nbytes)


def test_bound_takes_the_largest_term():
    tf, vf, nb = roofline.glu_work(16384, 2048, 8192, 2)
    assert roofline.bound_s(tf, vf, nb) == pytest.approx(tf / 989e12)
    _, vf, nb = roofline.elementwise_work(128 * 16384, 2)
    assert roofline.bound_s(0, vf, nb) == pytest.approx(nb / 3.35e12)
