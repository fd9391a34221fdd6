"""The program's own spans in a traced window: their device time, the
device operations launched inside them, and every idle gap of the device
charged to one of them.

The port opens its spans itself (``repro_torch.tracing``): with its
recording on, each is a ``record_function`` range named
``heteroedge.<name>`` in the profiler's trace, and an in-memory record
with the request's uid (``tracing.Recording``).  :func:`reduce` takes the
profiler's raw events (``trace.Recorder.stop``), that recording, and the
window's ends on the trace's clock (``time.time_ns``):

* each span name's host calls and seconds;
* each span name's device seconds and device operations: the operations
  on the stream of each of the span's device ranges, starting inside the
  range (as ``trace.reduce`` does for the benchmark's spans);
* ``idle_by_program_span``: every idle interval of the window, between
  and around the union of the device operations, charged to one name.
  First the innermost program span open, at the gap's end, on the thread
  that launched the operation ending the gap (found through the CUDA
  runtime or driver call with the operation's correlation id); failing
  that, the innermost program span on any thread at the gap's middle
  (``idle_fallback_s``); failing that, :data:`OUTSIDE`.  The parts sum to
  the window's idle time exactly (in integer nanoseconds).
  ``idle_under`` adds each charge to the span charged and to every span
  it is nested in on its thread.

The benchmark's harness does not call this yet: :func:`main` runs a traced
cell with the program's recording on by substituting the harness's
recorder in its own process, and prints the readings of the metrics that
read these numbers (``metrics/*.py`` that read ``run.program``)::

    python3 portbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.jsonl>]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

PREFIX = "heteroedge."
OUTSIDE = "outside every program span"
# the metrics that read ``run.program``
METRICS = ("queue_wait_p90_ms", "prefill_ms_per_request.device",
           "prefill_attention_ms_per_request.device", "decode_step_ms.device",
           "launches_per_decode_step", "device_idle_share.prefill",
           "device_idle_share.decode", "decode_attention_roofline.program")


@dataclass
class ProgramTrace:
    """What the metrics read of the program's spans in one traced window."""
    window_s: float
    idle_s: float
    host_calls: Dict[str, int] = field(default_factory=dict)
    host_s: Dict[str, float] = field(default_factory=dict)
    device_s: Dict[str, float] = field(default_factory=dict)
    device_ops: Dict[str, int] = field(default_factory=dict)
    idle_by_program_span: Dict[str, float] = field(default_factory=dict)
    idle_under: Dict[str, float] = field(default_factory=dict)
    idle_fallback_s: float = 0.0
    launch_events: int = 0             # CUDA runtime / driver launches
    launches_found: int = 0            # device ops whose launch was found
    device_ops_total: int = 0
    clock_offset_us: Dict[str, float] = field(default_factory=dict)
    records: object = None             # the tracing.Recording


class _Host:
    """The program's host spans, one flattened timeline a thread: on
    ``[bp[i], bp[i+1])`` the innermost open span is ``owner[i]`` (-1:
    none)."""

    def __init__(self, names, tids, starts, ends):
        self.names, self.starts = names, starts
        n = len(names)
        self.parent = np.full(n, -1, np.int64)
        self.lines: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for tid in sorted(set(tids)):
            mine = [i for i in range(n) if tids[i] == tid]
            mine.sort(key=lambda i: (starts[i], -ends[i]))
            bp, owner, stack = [], [], []

            def close_until(t):
                while stack and ends[stack[-1]] <= t:
                    j = stack.pop()
                    bp.append(ends[j])
                    owner.append(stack[-1] if stack else -1)

            for i in mine:
                close_until(starts[i])
                self.parent[i] = stack[-1] if stack else -1
                stack.append(i)
                bp.append(starts[i])
                owner.append(i)
            close_until(np.iinfo(np.int64).max)
            self.lines[tid] = (np.asarray(bp, np.int64),
                               np.asarray(owner, np.int64))

    def innermost(self, tid, t: np.ndarray) -> np.ndarray:
        """The innermost span open on thread ``tid`` at each time."""
        if tid not in self.lines:
            return np.full(len(t), -1, np.int64)
        bp, owner = self.lines[tid]
        i = np.searchsorted(bp, t, side="right") - 1
        return np.where(i >= 0, owner[np.maximum(i, 0)], -1)

    def innermost_any(self, t: np.ndarray) -> np.ndarray:
        """The innermost span on any thread: the latest-opened of the
        threads' innermost spans at each time."""
        best = np.full(len(t), -1, np.int64)
        best_start = np.full(len(t), -1, np.int64)
        starts = np.asarray(self.starts, np.int64)
        for tid in self.lines:
            own = self.innermost(tid, t)
            s = np.where(own >= 0, starts[np.maximum(own, 0)], -1)
            take = s > best_start
            best = np.where(take, own, best)
            best_start = np.where(take, s, best_start)
        return best

    def chain(self, i: int) -> List[str]:
        """The span's name and those of the spans it is nested in."""
        out = []
        while i >= 0:
            out.append(self.names[i])
            i = int(self.parent[i])
        return out


def _gaps(starts: np.ndarray, ends: np.ndarray, w0: int, w1: int):
    """The idle intervals of ``[w0, w1]`` around the union of the device
    operations (clipped to the window; between them as ``trace._union``
    gives them, and before the first and after the last): (gap starts,
    gap ends, index of the operation that ends each gap or -1)."""
    from portbench import trace as trace_mod

    keep = np.flatnonzero((ends > w0) & (starts < w1))
    s = np.clip(starts[keep], w0, w1)
    e = np.clip(ends[keep], w0, w1)
    _, g0, g1 = trace_mod._union(s, e)
    if len(keep):
        g0 = np.concatenate([[w0], g0, [e.max()]])
        g1 = np.concatenate([[s.min()], g1, [w1]])
    else:
        g0, g1 = np.asarray([w0], np.int64), np.asarray([w1], np.int64)
    order = np.argsort(s, kind="stable")
    at = np.searchsorted(s[order], g1, side="left")
    ender = np.full(len(g1), -1, np.int64)
    hit = at < len(s)
    ender[hit] = keep[order[at[hit]]]
    real = g1 > g0
    return g0[real], g1[real], ender[real]


def reduce(events, records, w0: int, w1: int) -> ProgramTrace:
    """Reduce the profiler's raw events over the window ``[w0, w1]``
    (``time.time_ns``) with the program's recording ``records``.  A host
    event's thread is its ``device_resource_id``, the system thread id
    (the one ``threading.get_native_id`` gives): a launch's
    ``start_thread_id`` is not its thread's."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    h_name, h_tid, h_start, h_end = [], [], [], []
    ranges: Dict[str, List[Tuple[int, int, int]]] = {}
    d_start, d_end, d_stream, d_corr = [], [], [], []
    launch: Dict[int, Tuple[int, int]] = {}     # correlation -> (tid, t)
    for ev in events:
        name = ev.name()
        t0 = ev.start_ns()
        if ev.device_type() == cuda:
            dur = ev.duration_ns()
            if ev.is_user_annotation():
                if name.startswith(PREFIX):
                    ranges.setdefault(name[len(PREFIX):], []).append(
                        (ev.device_resource_id(), t0, t0 + dur))
            elif dur > 0:
                d_start.append(t0)
                d_end.append(t0 + dur)
                d_stream.append(ev.device_resource_id())
                d_corr.append(ev.correlation_id())
        elif name.startswith(PREFIX):
            h_name.append(name[len(PREFIX):])
            h_tid.append(ev.device_resource_id())
            h_start.append(t0)
            h_end.append(t0 + ev.duration_ns())
        elif name.startswith("cu") and not ev.is_user_annotation():
            # a CUDA runtime or driver call (cudaLaunchKernel,
            # cuLaunchKernelEx, cudaMemcpyAsync, ...): the host side of
            # the device operation with its correlation id
            launch[ev.correlation_id()] = (ev.device_resource_id(), t0)

    out = ProgramTrace(window_s=(w1 - w0) * 1e-9, idle_s=0.0, records=records)
    for n, a, b in zip(h_name, h_start, h_end):
        out.host_calls[n] = out.host_calls.get(n, 0) + 1
        out.host_s[n] = out.host_s.get(n, 0.0) + (b - a) * 1e-9
    out.clock_offset_us = clock_offsets(records, h_name, h_start)

    ds, de = np.asarray(d_start, np.int64), np.asarray(d_end, np.int64)
    dstream = np.asarray(d_stream, np.int64)
    out.device_ops_total = len(ds)
    streams = {}
    for s in set(d_stream):
        mine = np.flatnonzero(dstream == s)
        order = mine[np.argsort(ds[mine], kind="stable")]
        cum = np.concatenate([[0], np.cumsum(de[order] - ds[order])])
        streams[s] = (ds[order], cum)
    for key, rs in ranges.items():
        total = n_ops = 0
        for s, a, b in rs:
            if s not in streams:
                continue
            starts, cum = streams[s]
            lo, hi = np.searchsorted(starts, [a, b], side="left")
            total += int(cum[hi] - cum[lo])
            n_ops += int(hi - lo)
        out.device_s[key] = total * 1e-9
        out.device_ops[key] = n_ops

    # every idle gap charged to one span
    host = _Host(h_name, h_tid, h_start, h_end)
    g0, g1, ender = _gaps(ds, de, w0, w1)
    length = g1 - g0
    owner = np.full(len(g0), -1, np.int64)
    tid_of = np.full(len(g0), -1, np.int64)
    for k in np.flatnonzero(ender >= 0):
        hit = launch.get(d_corr[ender[k]])
        if hit is not None:
            tid_of[k] = hit[0]
    out.launch_events = len(launch)
    out.launches_found = int(sum(c in launch for c in d_corr))
    for tid in set(tid_of[tid_of >= 0].tolist()):
        mine = np.flatnonzero(tid_of == tid)
        owner[mine] = host.innermost(tid, g1[mine])
    rest = np.flatnonzero(owner < 0)
    fallback = host.innermost_any((g0[rest] + g1[rest]) // 2)
    owner[rest] = fallback
    fell = int(length[rest[fallback >= 0]].sum())

    charged: Dict[int, int] = {}
    for i, n in zip(owner.tolist(), length.tolist()):
        charged[i] = charged.get(i, 0) + n
    by_name: Dict[str, int] = {}
    under: Dict[str, int] = {}
    for i, n in charged.items():
        name = OUTSIDE if i < 0 else h_name[i]
        by_name[name] = by_name.get(name, 0) + n
        for up in ([] if i < 0 else set(host.chain(i))):
            under[up] = under.get(up, 0) + n
    out.idle_s = int(length.sum()) * 1e-9
    out.idle_by_program_span = {k: v * 1e-9 for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])}
    out.idle_under = {k: v * 1e-9 for k, v in under.items()}
    out.idle_fallback_s = fell * 1e-9
    return out


def clock_offsets(records, names, starts) -> Dict[str, float]:
    """|profiler start - record start| in microseconds, median and
    largest, over the spans both hold (matched by name, in order of
    start): whether the records are on the trace's clock."""
    if records is None:
        return {}
    prof: Dict[str, List[int]] = {}
    for n, t in zip(names, starts):
        prof.setdefault(n, []).append(t)
    diffs = []
    for name, ts in prof.items():
        mine = sorted(r.start_ns for r in records.named(name))
        if len(mine) == len(ts):
            diffs += [abs(b - a) * 1e-3 for a, b in zip(mine, sorted(ts))]
    if not diffs:
        return {}
    return {"median": statistics.median(diffs), "max": max(diffs),
            "n": len(diffs)}


# ---------------------------------------------------------------------------
# what the readers compute
# ---------------------------------------------------------------------------
def per_call_ms(run, span: str, per: str) -> Optional[float]:
    """Device milliseconds inside ``span`` over the host calls of
    ``per``; None where either is missing."""
    p = getattr(run, "program", None)
    if p is None or not p.host_calls.get(per) or not p.device_s.get(span):
        return None
    return 1e3 * p.device_s[span] / p.host_calls[per]


def idle_share(run, span: str) -> Optional[float]:
    """The window's share idle and charged to ``span`` or a span nested
    in it."""
    p = getattr(run, "program", None)
    if p is None or p.window_s <= 0 or not p.host_calls.get(span):
        return None
    return 100.0 * p.idle_under.get(span, 0.0) / p.window_s


def queue_waits_s(records) -> List[float]:
    """Each request's wait from its arrival, the start of the
    ``runtime.serve`` call it came in, to the start of its first
    ``engine.prefill`` span, from the program's records."""
    spans, seen, out = records.spans, set(), []
    for r in spans:
        if r.name != "engine.prefill" or r.uid is None or r.uid in seen:
            continue
        seen.add(r.uid)
        up = r.parent
        while up is not None and spans[up].name != "runtime.serve":
            up = spans[up].parent
        if up is not None:
            out.append((r.start_ns - spans[up].start_ns) * 1e-9)
    return out


# ---------------------------------------------------------------------------
# a traced run with the program's recording on
# ---------------------------------------------------------------------------
def run_traced(root, cell: str, seed: int, seconds: float, **kw) -> Dict:
    """``harness.run_cell`` traced, with the program's recording on over
    the profiler's window: the harness's recorder and ``compute_metrics``
    are substituted in this process for the run and restored after it.
    The result line gains the readings of :data:`METRICS` and a
    ``program`` object (the reduction's totals and clock)."""
    from portbench import harness
    from portbench import trace as trace_mod
    from repro_torch import tracing

    held = {}

    class ProgramRecorder(trace_mod.Recorder):
        def start(self):
            self._rec = tracing.recording()
            held["records"] = self._rec.__enter__()
            super().start()
            held["w0"] = time.time_ns()

        def stop(self):
            held["w1"] = time.time_ns()
            events = super().stop()
            self._rec.__exit__(None, None, None)
            held["events"] = events
            return events

    def compute_with_program(pb, bench, run, traced):
        t = time.perf_counter()
        run.program = reduce(held.pop("events"), held["records"],
                             held["w0"], held["w1"])
        held["reduce_s"] = time.perf_counter() - t
        out = compute(pb, bench, run, traced)
        for name in METRICS:
            r = harness.reader(pb, name)
            value = r.read(run)
            if value is not None:
                out[name] = {"value": float(value), "unit": r.UNIT}
        held["program"] = run.program
        return out

    recorder, compute = trace_mod.Recorder, harness.compute_metrics
    trace_mod.Recorder = ProgramRecorder
    harness.compute_metrics = compute_with_program
    try:
        res = harness.run_cell(root, cell, seed, seconds, True, **kw)
    finally:
        trace_mod.Recorder, harness.compute_metrics = recorder, compute
    p, recs = held["program"], held["records"]
    res["program"] = {
        "window_s": p.window_s, "idle_s": p.idle_s,
        "idle_fallback_s": p.idle_fallback_s,
        "idle_by_program_span": p.idle_by_program_span,
        "idle_under": p.idle_under, "device_s": p.device_s,
        "device_ops": p.device_ops, "host_calls": p.host_calls,
        "host_s": p.host_s, "launch_events": p.launch_events,
        "launches_found": p.launches_found,
        "device_ops_total": p.device_ops_total,
        "clock_offset_us": p.clock_offset_us, "reduce_s": held["reduce_s"],
        "spans_recorded": len(recs.spans)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from portbench import run as entry
    entry.prepare()
    from portbench import program_trace      # the package's, not __main__
    res = program_trace.run_traced(root, args.workload, args.seed,
                                   args.seconds, t_start=t_start)
    p = res["program"]
    print(f"program: idle {p['idle_s']:.3f} of {p['window_s']:.3f} s, "
          f"fallback {p['idle_fallback_s']:.3f} s, outside "
          f"{p['idle_by_program_span'].get(OUTSIDE, 0.0):.3f} s; launches "
          f"found {p['launches_found']} of {p['device_ops_total']}; clock "
          f"{p['clock_offset_us']}", file=sys.stderr, flush=True)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
