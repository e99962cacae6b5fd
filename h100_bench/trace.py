"""The traced run: spans from the benchmark's own code around the program's
layers, a ``torch.profiler`` window, and its reduction to kernel intervals.

The port has no span of its own, so ``spans`` wraps module attributes of the
port (its functions and the methods of its classes, looked up at call time)
in ``torch.profiler.record_function`` for the traced run only; no file of
the port changes. The trace is read from its Chrome-trace export: device
intervals (kernels, copies, fills), each kernel's launch (by its
correlation id) and the spans open on the launching thread at that moment.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _wrap(owner, attr: str, span: str, static: bool = False):
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(span):
            return fn(*args, **kwargs)

    setattr(owner, attr, staticmethod(wrapped) if static else wrapped)
    return owner, attr, fn, static


@contextlib.contextmanager
def spans():
    """Spans around the port's layers while the context is open: the conv
    kernels' autograd function (``conv3.fwd``, ``conv3.bwd``) and its weight
    gradient (``conv3.dw``), the U-Net (``unet``), the integration
    (``integrate``), the dense warps (``warp``) and SynthMorph's synthesis
    (``synthesis``)."""
    from voxelmorph_tpu_torch.models import synthmorph, unet
    from voxelmorph_tpu_torch.ops import conv3, warp

    saved = [
        _wrap(conv3._Conv3Block, "forward", "conv3.fwd", static=True),
        _wrap(conv3._Conv3Block, "backward", "conv3.bwd", static=True),
        _wrap(conv3, "_shifted_dw_db", "conv3.dw"),
        _wrap(unet.Unet, "forward", "unet"),
        _wrap(warp, "integrate_vec_batched", "integrate"),
        _wrap(warp, "transform_batched", "warp"),
        _wrap(synthmorph, "labels_to_image_from_draws", "synthesis"),
        _wrap(synthmorph.SynthMorphDense, "draw", "synthesis"),
    ]
    try:
        yield
    finally:
        for owner, attr, fn, static in reversed(saved):
            setattr(owner, attr, staticmethod(fn) if static else fn)


class Recorder:
    """A profiler window (CPU and CUDA activity) inside a ``bench.window``
    span, opened by ``start`` and closed by ``stop``, which returns the
    ``Trace``."""

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()

    def stop(self) -> "Trace":
        self.span.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        return Trace(events.get("traceEvents", []) if isinstance(events, dict) else events)


def record(fn: Callable[[], object]):
    """Run ``fn`` in a ``Recorder``'s window; return (its result, the
    ``Trace``)."""
    rec = Recorder()
    rec.start()
    try:
        out = fn()
    finally:
        tr = rec.stop()
    return out, tr


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted disjoint intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def open_spans(spans: List[Tuple[float, float, str]], queries: List[Tuple[float, int]]):
    """For each (time, key) of ``queries`` in time order, the names of the
    spans of one thread open at that time (spans on a thread nest), as
    (key, names)."""
    spans = sorted(spans)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for t, key in queries:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        yield key, [n for s0, s1, n in stack if s1 >= t]


class Kernel:
    __slots__ = ("name", "start", "end", "spans")

    def __init__(self, name, start, end, spans):
        self.name, self.start, self.end, self.spans = name, start, end, spans

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6


class Trace:
    """The reduction of a traced window (times in microseconds, as the
    export gives them): ``window`` (start, end) of the ``bench.window``
    span, ``device`` intervals clipped to it, ``kernels`` (each with the
    names of the spans open at its launch) and the host's CPU events."""

    def __init__(self, events: List[Dict]):
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace has no bench.window span")
        w = win[0]
        self.window = (float(w["ts"]), float(w["ts"]) + float(w["dur"]))
        self.host_tid = w.get("tid")
        lo, hi = self.window
        spans_by_tid: Dict[object, List[Tuple[float, float, str]]] = {}
        launches: Dict[int, Tuple[object, float]] = {}
        self.cpu: List[Tuple[float, float, str]] = []
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat == "user_annotation" and e["name"] != WINDOW:
                spans_by_tid.setdefault(e.get("tid"), []).append((ts, ts + dur, e["name"]))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("tid"), ts)
            elif cat in DEVICE_CATS:
                a, b = max(ts, lo), min(ts + dur, hi)
                if b > a:
                    device.append((e, a, b))
            if cat in ("cpu_op", "user_annotation") and e.get("tid") == self.host_tid \
                    and e["name"] != WINDOW:
                self.cpu.append((ts, ts + dur, e["name"]))
        self.cpu.sort()
        self.kernels: List[Kernel] = []
        self.intervals = []
        queries: Dict[object, List[Tuple[float, int]]] = {}
        for e, a, b in device:
            self.intervals.append((a, b))
            if e.get("cat") != "kernel":
                continue
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is not None:
                queries.setdefault(launch[0], []).append((launch[1], len(self.kernels)))
            self.kernels.append(Kernel(e["name"], a, b, []))
        for tid, qs in queries.items():
            for t, names in open_spans(spans_by_tid.get(tid, []), sorted(qs)):
                self.kernels[t].spans = names

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.intervals)) * 1e-6

    def kernel_seconds(self, where: Callable[[Kernel], bool]) -> float:
        return sum(k.seconds for k in self.kernels if where(k))

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time: [[name, seconds]]."""
        by: Dict[str, float] = {}
        for k in self.kernels:
            key = k.name[:160]
            by[key] = by.get(key, 0.0) + k.seconds
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 400) -> List[List]:
        """The device's idle time in the window by what the host's thread
        was doing at each gap's middle (its innermost CPU op or span), over
        the ``longest`` gaps: [[label, seconds]], the largest first."""
        busy = union(self.intervals)
        lo, hi = self.window
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        starts = [c[0] for c in self.cpu]
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label = "host: no op"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if self.cpu[j][1] >= mid:
                    label = self.cpu[j][2][:160]
                    break
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_percent(run) -> Optional[float]:
    """The share of a run's traced window in which no operation ran on the
    device, in percent (``idle_share.*``)."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def breakdown(trace: Optional[Trace]) -> Optional[Dict]:
    if trace is None:
        return None
    return {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
