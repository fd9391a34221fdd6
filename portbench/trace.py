"""Reduction of a ``torch.profiler`` trace to what the metrics read.

The benchmark's spans are ``record_function`` ranges it opens around the
program's functions (:func:`wrap`).  The profiler records them on every
thread (the continuous engine launches its decode steps from a worker
thread) and records no host operator but them, so that a traced window
costs little more than the run it traces.  For each span range the
profiler also lays a range on the device over the operations launched
inside it, on the stream they ran on; the span's device time is the sum
of the operations on that stream inside that range.
"""
from __future__ import annotations

import functools
import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

SPAN_PREFIX = "portbench."
NAME_CHARS = 120            # a device operation's name, cut to this


def wrap(targets: Dict[str, Tuple[str, str]]):
    """Open a span named ``portbench.<name>`` around each target function
    ``(module, attribute)`` (an attribute may be ``Class.method``),
    replacing it where it lives.  Returns (the names whose function
    exists, a function that restores them all)."""
    import torch

    found, undo = set(), []
    for name, (module, attr) in targets.items():
        owner = importlib.import_module(module)
        *path, leaf = attr.split(".")
        for part in path:
            owner = getattr(owner, part, None)
        raw = owner.__dict__.get(leaf) if owner is not None else None
        fn = getattr(owner, leaf, None)
        if not callable(fn):
            continue

        def spanned(*args, __fn=fn, __span=SPAN_PREFIX + name, **kw):
            with torch.profiler.record_function(__span):
                return __fn(*args, **kw)

        new = functools.wraps(fn)(spanned)
        if isinstance(raw, staticmethod):
            new = staticmethod(new)
        setattr(owner, leaf, new)
        undo.append((owner, leaf, raw if raw is not None else fn))
        found.add(name)

    def restore():
        for owner, leaf, old in reversed(undo):
            setattr(owner, leaf, old)

    return found, restore


class Recorder:
    """The profiler over host spans (user scope only) and device activity
    on every thread; ``stop`` returns the raw events."""

    def __init__(self):
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, RecordScope,
                                        _ExperimentalConfig)
        args = (ProfilerState.KINETO, False, False, False, False, False,
                _ExperimentalConfig(profile_all_threads=True))
        try:
            self.config = ProfilerConfig(*args, "")
        except TypeError:
            self.config = ProfilerConfig(*args)
        self.activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        self.scopes = {RecordScope.USER_SCOPE}

    def start(self) -> None:
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities, self.scopes)

    def stop(self):
        from torch._C._autograd import _disable_profiler
        return _disable_profiler().events()


@dataclass
class Trace:
    """What the metrics read from one traced window."""
    window_s: float                     # host seconds the profiler ran
    busy_s: float                       # union of device operations
    device_ops: List[Tuple[str, float]]            # name, seconds (top 10)
    idle_gaps: List[Tuple[str, float]]             # host span, seconds
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_calls: Dict[str, int] = field(default_factory=dict)
    span_ranges: Dict[str, int] = field(default_factory=dict)
    ops_by_stream: Dict[int, int] = field(default_factory=dict)


def _union(starts: np.ndarray, ends: np.ndarray):
    """(busy seconds, gap starts, gap ends) of intervals in ns."""
    if not len(starts):
        return 0.0, np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    seg_start = s[new]
    seg_end = np.maximum.reduceat(e, np.flatnonzero(new))
    busy = float((seg_end - seg_start).sum()) * 1e-9
    return busy, seg_end[:-1], seg_start[1:]


def reduce(events, window_s: float, spans=(), top: int = 10) -> Trace:
    """Reduce the profiler's events (:meth:`Recorder.stop`)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    d_start, d_end, d_name, d_stream = [], [], [], []
    ranges: Dict[str, List[Tuple[int, int, int]]] = {s: [] for s in spans}
    calls: Dict[str, int] = {s: 0 for s in spans}
    h_start, h_end, h_name, h_tid = [], [], [], []
    for ev in events:
        t0, dur = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if ev.device_type() == cuda:
            if ev.is_user_annotation():
                key = name[len(SPAN_PREFIX):]
                if key in ranges:
                    ranges[key].append((ev.device_resource_id(), t0, t0 + dur))
            elif dur > 0:
                d_start.append(t0)
                d_end.append(t0 + dur)
                d_name.append(name)
                d_stream.append(ev.device_resource_id())
            continue
        if name.startswith(SPAN_PREFIX):
            key = name[len(SPAN_PREFIX):]
            if key in calls:
                calls[key] += 1
            h_start.append(t0)
            h_end.append(t0 + dur)
            h_name.append(key)
            h_tid.append(ev.start_thread_id())

    ds, de = np.asarray(d_start, np.int64), np.asarray(d_end, np.int64)
    dstream = np.asarray(d_stream, np.int64)
    busy, gap_s, gap_e = _union(ds, de)

    by_name: Dict[str, int] = {}
    for n, a, b in zip(d_name, d_start, d_end):
        n = n[:NAME_CHARS]
        by_name[n] = by_name.get(n, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # the longest idle gaps, each named by the innermost span the host was
    # in at its middle (on any thread)
    hs, he = np.asarray(h_start, np.int64), np.asarray(h_end, np.int64)
    gaps = []
    if len(gap_s):
        length = gap_e - gap_s
        for i in np.argsort(-length)[:top - 1]:
            mid = (gap_s[i] + gap_e[i]) // 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            label = "outside every span"
            if len(cover):
                j = cover[np.argmax(hs[cover])]
                label = f"{h_name[j]} (thread {h_tid[j]})"
            gaps.append((label, float(length[i]) * 1e-9))
        short = length[length < 1_000_000]
        gaps.append((f"all {len(short)} gaps under 1 ms",
                     float(short.sum()) * 1e-9))

    # each span's device time: the operations on its range's stream that
    # start inside the range
    span_s: Dict[str, float] = {}
    streams = {}
    for s in set(dstream.tolist()):
        mine = np.flatnonzero(dstream == s)
        order = mine[np.argsort(ds[mine], kind="stable")]
        cum = np.concatenate([[0], np.cumsum(de[order] - ds[order])])
        streams[s] = (ds[order], cum)
    for key, rs in ranges.items():
        total = 0
        for s, a, b in rs:
            if s not in streams:
                continue
            starts, cum = streams[s]
            lo, hi = np.searchsorted(starts, [a, b], side="left")
            total += int(cum[hi] - cum[lo])
        span_s[key] = total * 1e-9
    return Trace(window_s=window_s, busy_s=busy, device_ops=[
        (n, v * 1e-9) for n, v in ops], idle_gaps=gaps,
        span_device_s=span_s, span_calls=calls,
        span_ranges={k: len(v) for k, v in ranges.items()},
        ops_by_stream={int(s): int((dstream == s).sum()) for s in streams})


def device_seconds(trace: Optional[Trace], span: str) -> Optional[float]:
    """Device seconds inside a span, or None where the span never ran or
    no device operation ran inside it."""
    if trace is None or not trace.span_calls.get(span):
        return None
    s = trace.span_device_s.get(span, 0.0)
    return s if s > 0 else None
