"""The traced slice: a few steady steps of a run under ``torch.profiler``,
read back from its Chrome trace (written under the run's TMPDIR and
deleted at once).

What the slice gives: every device operation (kernels, copies, sets) with
its name and device interval; the host range each kernel was launched in
(the benchmark's own ``record_function`` ranges, through the launch's
correlation id, or in stream order where a launch has none); the kernel
launches the benchmark recorded on the host with their shapes (``Launches``),
matched to the device's kernels in stream order; and the slice's length.

A guard against a trace that lost events (the profiler does, now and
then): CUDA events bracket the same slice, and the profiler's device
span has to agree with their elapsed time, and its busy time may not
exceed it. ``take`` retakes a slice once when they disagree, and marks it
unsound if the second one disagrees too: readers then report nothing.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver"}
# a kernel of the program's two hand-written kernels, by symbol prefix
KERNEL_PREFIX = {"glu_2d": "repro_glu", "elementwise_2d": "repro_elementwise"}


def is_kernel_of(name: str, kernel: str) -> bool:
    """Whether the device kernel ``name`` (demangled, e.g. ``void
    (anonymous namespace)::repro_glu_bf16_tma_kernel<2, 64, 2>(...)``) is
    one of ``kernel``'s."""
    return re.search(r"(^|[\s:])" + KERNEL_PREFIX[kernel] + r"\w*[<(]", name) \
        is not None


class Launches:
    """Host records of the hand-written kernels' launches: (kernel, host
    range, shape facts), taken by wrapping the program's two wrappers for
    the slice's duration."""

    def __init__(self):
        self.records: list[tuple[str, str, dict]] = []
        self.range = "other"

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.kernels import epilogue as epi
        orig = {"glu_2d": epi.glu_2d, "elementwise_2d": epi.elementwise_2d}

        def glu(x, w_gate, w_up, params, **kw):
            (m, k), n = x.shape, w_gate.shape[1]
            if m * n * k and x.is_cuda:
                self.records.append(("glu_2d", self.range, dict(
                    m=m, k=k, n=n, itemsize=x.element_size(),
                    act=kw.get("act", "silu"), params=params.numel())))
            return orig["glu_2d"](x, w_gate, w_up, params, **kw)

        def elementwise(x, params, **kw):
            if x.numel() and x.is_cuda:
                self.records.append(("elementwise_2d", self.range, dict(
                    n=x.numel(), itemsize=x.element_size(),
                    act=kw.get("act", "tanh"), params=params.numel())))
            return orig["elementwise_2d"](x, params, **kw)

        epi.glu_2d, epi.elementwise_2d = glu, elementwise
        try:
            yield self
        finally:
            epi.glu_2d, epi.elementwise_2d = orig["glu_2d"], \
                orig["elementwise_2d"]

    @contextlib.contextmanager
    def in_range(self, name: str):
        """A host range: a ``record_function`` of that name, and the range
        the launches inside it are recorded under."""
        prev, self.range = self.range, name
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.range = prev


class Slice:
    """One parsed slice."""

    def __init__(self, events: list, event_ms: float, launches: list,
                 steps: dict):
        self.event_s = event_ms / 1e3
        self.steps = steps                       # range -> steps run in it
        ranges = [e for e in events if e.get("cat") == "user_annotation"]
        whole = [e for e in ranges if e["name"] == "bench.slice"]
        if not whole:
            raise RuntimeError("the trace has no bench.slice range")
        s0 = whole[0]["ts"]
        self.window_s = whole[0]["dur"] / 1e6
        self.ops = sorted(((e["name"], e["ts"], e["dur"], e.get("cat"),
                            e.get("args", {}).get("correlation"))
                           for e in events if e.get("cat") in DEVICE_CATS
                           and e.get("ph") == "X"), key=lambda o: o[1])
        launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                     if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                     and "correlation" in e.get("args", {})}
        named = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                        for e in ranges if e["name"].startswith("bench.")
                        and e["name"] != "bench.slice"))

        def range_of(ts):
            best = "other"
            for a, b, name in named:
                if a <= ts <= b:
                    best = name
            return best

        # each kernel's launch range; a kernel whose launch the trace lost
        # takes its predecessor's (one stream: device order = launch order)
        self.kernels = []
        self.unlinked = 0
        prev = "other"
        for name, ts, dur, cat, corr in self.ops:
            if cat != "kernel":
                continue
            self.unlinked += corr not in launch_ts
            rng = range_of(launch_ts[corr]) if corr in launch_ts else prev
            prev = rng
            self.kernels.append((name, ts, dur, rng))
        self.host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") in ("cpu_op", "user_annotation",
                                         "python_function")
                     and e.get("ph") == "X"]
        self.start, self.end = s0, s0 + whole[0]["dur"]
        self.launches = launches
        self.span_s = ((self.ops[-1][1] + self.ops[-1][2] - self.ops[0][1]) / 1e6
                       if self.ops else 0.0)
        self.busy_s = _union(((o[1], o[1] + o[2]) for o in self.ops)) / 1e6

    def sound(self) -> tuple[bool, str]:
        """Whether the profiler kept the slice whole, by the CUDA events."""
        if not self.ops:
            return False, "no device operation in the trace"
        if self.busy_s > self.event_s * 1.02 + 1e-4:
            return False, (f"profiler busy {self.busy_s:.6f} s > CUDA-event "
                           f"elapsed {self.event_s:.6f} s")
        if self.span_s < 0.9 * self.event_s - 1e-3:
            return False, (f"profiler device span {self.span_s:.6f} s < 0.9 x "
                           f"CUDA-event elapsed {self.event_s:.6f} s")
        return True, "ok"

    def kernel_pairs(self, kernel: str):
        """[(record, device seconds)] of ``kernel``'s launches, the i-th
        host record with the i-th such kernel on the device; None when the
        counts differ (a launch missing its kernel)."""
        dev = [k for k in self.kernels if is_kernel_of(k[0], kernel)]
        host = [r for r in self.launches if r[0] == kernel]
        if len(dev) != len(host):
            return None
        return [(h, d[2] / 1e6) for h, d in zip(host, dev)]

    def counts(self, kernel: str) -> str:
        dev = [k[0] for k in self.kernels if is_kernel_of(k[0], kernel)]
        host = [r for r in self.launches if r[0] == kernel]
        return (f"{len(host)} launches, {len(dev)} kernels: "
                f"{sorted(set(n[:120] for n in dev))}")

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for name, _, dur, _, _ in self.ops:
            by[name] += dur / 1e6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10, named: int = 400):
        """The device's idle time inside the slice, summed by the innermost
        host operation running at the middle of each of the ``named``
        longest gaps; the rest summed as one entry."""
        gaps, t = [], self.start
        for _, ts, dur, _, _ in self.ops + [("", self.end, 0, None, None)]:
            if ts > t:
                gaps.append((ts - t, 0.5 * (t + ts)))
            t = max(t, ts + dur)
        gaps.sort(reverse=True)
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by = defaultdict(float)
        for dur, mid in gaps[:named]:
            best, i = None, bisect.bisect_right(starts, mid)
            for h in reversed(host[max(0, i - 4000):i]):
                if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                    best = h
            by[best[2] if best else "host: no traced operation"] += dur / 1e6
        rest = sum(g[0] for g in gaps[named:]) / 1e6
        if rest:
            by["(shorter gaps)"] += rest
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]


def _union(intervals) -> float:
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _profile(run, launches: Launches, steps: dict) -> Slice:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    launches.records.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.slice"):
            ev0.record()
            with launches.installed():
                run()
            ev1.record()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Slice(events, ev0.elapsed_time(ev1), list(launches.records),
                 dict(steps))


def take(run, steps: dict, say) -> Slice:
    """Profile ``run()`` (which fills ``steps`` with the steps it ran by
    range), retaking once if the profiler and the CUDA events disagree."""
    launches = Launches()
    for attempt in (1, 2):
        steps.clear()
        sl = _profile(lambda: run(launches), launches, steps)
        ok, why = sl.sound()
        sl.ok, sl.why = ok, why
        say(f"traced slice {attempt}: {len(sl.ops)} device operations, "
            f"{len(sl.kernels)} kernels ({sl.unlinked} without a launch "
            f"record), busy {sl.busy_s:.6f} s of {sl.window_s:.6f} s, "
            f"CUDA events {sl.event_s:.6f} s, steps {sl.steps}")
        if ok:
            return sl
        say(f"traced slice {attempt}: {why}")
    return sl
