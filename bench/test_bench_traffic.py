"""The benchmark's traffic generator: a pure function of the seed, the
same sizes for every seed in another order, within the mixes' ranges."""
import json
from pathlib import Path

import numpy as np
import pytest

from benchlib import traffic

HERE = Path(__file__).resolve().parent
MIXES = {p.stem: json.loads(p.read_text())
         for p in sorted((HERE / "traffic").glob("*.json"))}
SEEDS = (0, 7, 2**31 + 11, 2**40 + 3)


@pytest.mark.parametrize("name", sorted(m for m in MIXES
                                        if MIXES[m]["kind"] == "serve"))
def test_requests_pure_in_range_same_sizes(name):
    mix = MIXES[name]
    runs = {s: traffic.requests(mix, 300, 50304, s) for s in SEEDS}
    again = traffic.requests(mix, 300, 50304, SEEDS[2])
    assert all((a[0] == b[0]).all() and a[1] == b[1]
               for a, b in zip(runs[SEEDS[2]], again))
    sizes = None
    for s, reqs in runs.items():
        p = np.array([len(r[0]) for r in reqs])
        o = np.array([r[1] for r in reqs])
        assert p.min() >= mix["prompt_len"]["min"]
        assert p.max() <= mix["prompt_len"]["max"]
        assert o.min() >= mix["output_len"]["min"]
        assert o.max() <= mix["output_len"]["max"]
        assert all(0 <= r[0].min() and r[0].max() < 50304 for r in reqs)
        key = (sorted(p), sorted(o))
        assert sizes is None or key == sizes, "a seed changed the work"
        sizes = key
    assert [len(r[0]) for r in runs[SEEDS[0]]] != \
        [len(r[0]) for r in runs[SEEDS[1]]]


@pytest.mark.parametrize("seed", SEEDS)
def test_arrivals_same_gaps_in_another_order(seed):
    a = traffic.arrivals(5.3, 400, seed)
    b = traffic.arrivals(5.3, 400, 1)
    assert (np.diff(a) > 0).all()
    assert a[-1] == pytest.approx(b[-1])
    assert np.array_equal(a, traffic.arrivals(5.3, 400, seed))
    assert abs(a[-1] / 400 - 1 / 5.3) < 0.02 / 5.3


@pytest.mark.parametrize("seed", SEEDS)
def test_train_ring_packs_documents(seed):
    mix = MIXES["train"]
    tok, lab = traffic.train_ring(mix, 2, 64, 3, 1000, 999, seed)
    tok2, lab2 = traffic.train_ring(mix, 2, 64, 3, 1000, 999, seed)
    assert tok.shape == lab.shape == (3, 2, 64)
    assert np.array_equal(tok, tok2) and np.array_equal(lab, lab2)
    flat_t = tok.reshape(6, 64)
    flat_l = lab.reshape(6, 64)
    assert np.array_equal(flat_t[:, 1:], flat_l[:, :-1])
    assert tok.min() >= 0 and tok.max() < 1000
    assert len({r.tobytes() for r in flat_t}) == 6, "rows repeat"


def test_lognormal_quantiles_clip_and_median():
    d = {"dist": "lognormal", "median": 512, "sigma": 0.7, "min": 128,
         "max": 2048}
    q = traffic.quantiles(d, 1001)
    assert q.min() >= 128 and q.max() <= 2048
    assert np.median(q) == pytest.approx(512, rel=1e-3)
