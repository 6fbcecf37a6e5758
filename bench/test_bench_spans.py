"""The readers of the program's spans: the idle time inside a host range
of a hand-made slice (gaps inside, across and outside ranges, nested
ranges, a range with no device operation), the device times by span
from a CPU profiler run, and nothing read from a program without spans."""
import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile

import run as bench_run
from benchlib import readers, spans, trace
from repro_torch import spans as program_spans

# the slice [0, 100] us; kernels [10, 20], [30, 50], [60, 70], [90, 95]
KERNELS = [(10, 10), (30, 20), (60, 10), (90, 5)]
# decode [5, 40] (a kernel runs across its end) holding attention
# [12, 35]; decode [55, 105] runs past the slice's end; admit [80, 88]
# holds no device operation
RANGES = [("repro.serve.decode", 5, 35), ("repro.model.attention", 12, 23),
          ("repro.serve.decode", 55, 50), ("repro.serve.admit", 80, 8)]


def hand_slice():
    ev = [{"cat": "user_annotation", "name": "bench.slice", "ph": "X",
           "ts": 0, "dur": 100}]
    ev += [{"cat": "kernel", "name": f"k{i}", "ph": "X", "ts": ts, "dur": d,
            "args": {"correlation": i}} for i, (ts, d) in enumerate(KERNELS)]
    ev += [{"cat": "user_annotation", "name": n, "ph": "X", "ts": ts,
            "dur": d} for n, ts, d in RANGES]
    sl = trace.Slice(ev, 0.1, [], {})
    sl.ok, sl.why = True, "ok"
    return sl


def record(sl=None):
    return types.SimpleNamespace(slice=sl, notes=[])


@pytest.fixture(autouse=True)
def _fresh():
    program_spans.reset()
    yield
    program_spans.reset()


@pytest.mark.parametrize("intervals, want", [
    ([(3, 5), (1, 2), (4, 8)], [(1, 2), (3, 8)]),
    ([(-5, 1), (9, 20), (2, 2)], [(0, 1), (9, 10)]),
    ([(0, 10), (2, 3)], [(0, 10)]),
    ([], []),
])
def test_merged_clips_and_joins(intervals, want):
    assert spans.merged(intervals, 0, 10) == want


def test_overlap_of_sorted_unions():
    xs, ys = [(0, 4), (6, 10)], [(2, 7), (9, 12)]
    assert spans.overlap(xs, ys) == 2 + 1 + 1
    assert spans.overlap(xs, []) == 0.0


@pytest.mark.parametrize("name, idle_us", [
    ("repro.serve.decode", 5 + 10 + 5 + 20 + 5),   # inside, clipped at 100
    ("repro.model.attention", 10),                 # nested in a decode range
    ("repro.serve.admit", 8),                      # no device operation
    ("repro.serve.harvest", None),                 # not in the slice
])
def test_idle_inside(name, idle_us):
    got = spans.idle_inside(hand_slice(), name)
    if idle_us is None:
        assert got is None
    else:
        assert got == pytest.approx(idle_us / 1e6)


def test_shares_fit_inside_the_idle_share():
    rec = record(hand_slice())
    decode = spans.idle_share_inside(rec, "repro.serve.decode")
    admit = spans.idle_share_inside(rec, "repro.serve.admit")
    assert decode == pytest.approx(45.0) and admit == pytest.approx(8.0)
    assert decode + admit <= readers.idle_share(rec) == pytest.approx(55.0)


def test_an_unsound_slice_reads_nothing():
    sl = hand_slice()
    sl.ok, sl.why = False, "lost events"
    rec = record(sl)
    assert spans.idle_share_inside(rec, "repro.serve.decode") is None
    assert rec.notes == ["trace unsound: lost events"]


def profiled_spans():
    """Two train steps of forward 1 + backward 2 + optimizer 1 spans, and
    a decode holding two attention spans, under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with program_spans.span("train.step"):
                for name in ("forward", "backward", "backward", "optimizer"):
                    with program_spans.span("train." + name):
                        pass
        with program_spans.span("serve.decode"):
            for _ in range(2):
                with program_spans.span("model.attention"):
                    sum(range(1000))


def test_train_phase_ms_is_per_step():
    profiled_spans()
    d = program_spans.device_ms()
    assert spans.train_phase_ms("train.backward") == pytest.approx(
        d["train.backward"][1] / 2)
    assert spans.train_phase_ms("train.reduce") is None


NEW = ["forward_ms.train", "backward_ms.train", "optimizer_ms.train",
       "attention_share.decode", "idle_in_decode_share.decode",
       "idle_in_decode_share.chat", "idle_in_admit_share.chat"]


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_the_programs_spans(name):
    profiled_spans()
    v = bench_run._reader(name)(record(hand_slice()))
    assert v is not None and v >= 0.0
    if name.endswith("_share.decode") or name.endswith("_share.chat"):
        assert v <= 100.0


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_program_without_spans_reads_nothing(name, monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    bare = hand_slice()
    bare.host = [h for h in bare.host if not h[2].startswith("repro.")]
    assert bench_run._reader(name)(record(bare)) is None
