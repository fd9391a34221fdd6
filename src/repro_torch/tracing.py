"""Spans inside the port, off unless a caller records.

``span(name, uid=None, **attrs)`` marks one layer boundary (the names are
listed in ``SPANS``).  Off, the default, it reads one module flag and
returns a shared no-op context: no profiler range is entered, nothing is
appended, the device is neither synced nor written.  On, inside ``with
recording() as rec``, each span opens a ``torch.profiler.record_function``
range named ``heteroedge.<name>`` (in a profiled window it lands in the
same trace as the device operations, with a device range over whatever
it launched) and appends a :class:`SpanRecord` to ``rec``: name, uid,
parent span, thread, start and end.  Records are stamped with
``time.time_ns()``, the clock ``torch.profiler`` stamps its events with,
and stay in memory until the caller reads ``rec``.

``timed(...)`` is a span that times itself in either state: where the
engine fills a ``ContinuousStats`` bucket (or the runtime a wall in its
telemetry) the span at that boundary gives the seconds.  A request
arrives when the ``runtime.serve`` call it came in opens; its prefill is
its ``engine.prefill`` span (uid).

A span opened on another thread than its cause (the decode launcher's
macro-step) takes the causing span's id as ``parent`` (:func:`current` on
the submitting thread).  Only a caller turns recording on, through this
API; nothing in the environment does.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch

PREFIX = "heteroedge."

# every span the port opens: name -> where, and what one span covers
SPANS = {
    "runtime.serve": "core/topology.py: HeteroRuntime.serve, a call",
    "runtime.wave": "core/topology.py: a wave's group loop (attr wave)",
    "runtime.group": "core/topology.py: one group's engine runs in a wave "
                     "(attr group)",
    "engine.run": "serving/engine.py: ContinuousServingEngine.run, a call",
    "engine.boundary": "serving/engine.py: admission at a macro boundary "
                       "(overlapped step 1; the boundary path's admit phase)",
    "engine.splice": "serving/engine.py: the admitted blocks written into "
                     "the decode cache (admit_boundary / write_slot_cache)",
    "engine.dispatch": "serving/engine.py: launching a macro-step (step 2)",
    "engine.topup": "serving/engine.py: shadow prefills behind the "
                    "in-flight macro-step (step 3)",
    "engine.await": "serving/engine.py: the token block and first tokens "
                    "read (step 4)",
    "engine.consume": "serving/engine.py: host bookkeeping of a token block",
    "engine.per_step": "serving/engine.py: one step of the macro_steps=0 "
                       "loop with its token read",
    "engine.prefill": "serving/engine.py: one request's prefill (uid; attr "
                      "exposed)",
    "engine.macro_step": "serving/engine.py: one launch of the fused decode "
                         "program, on the launcher thread or inline",
    "model.prefill": "serving/engine.py: make_prefill_step's step",
    "model.decode_step": "serving/engine.py: one decode step of the fused "
                         "loop or the per-step path",
    "attention.full": "models/attention.py: attention over a whole "
                      "sequence (prefill, training forward, "
                      "cross-attention), a layer: the prefill_attention "
                      "kernel or chunked_attention",
    "kernels.decode_attention": "kernels/ops.py: decode_attention, a call",
    "attention.mla_prefill": "models/attention.py: an MLA layer's attention "
                             "over a whole sequence with the latent "
                             "expanded: the prefill_attention kernel's qk "
                             "192 / v 128 instance or chunked_attention",
    "attention.mla_decode": "models/attention.py: an MLA layer's decode "
                            "attention over the latent cache: the "
                            "mla_decode_attention kernel or its plain "
                            "version",
    "moe.route": "models/moe.py: an MoE layer's router (an MLAConfig's "
                 "sigmoid + bias one)",
    "moe.experts": "models/moe.py: its dispatch, routed experts "
                   "(grouped_ffn) and weighted combine",
    "moe.shared": "models/moe.py: its shared experts' SwiGLU",
}


@dataclass
class SpanRecord:
    id: int                       # index in Recording.spans
    name: str                     # without the "heteroedge." prefix
    uid: Optional[int]            # the request the span serves
    parent: Optional[int]         # the enclosing (or causing) span's id
    thread: int                   # threading.get_native_id()
    start_ns: int = 0             # time.time_ns()
    end_ns: int = 0               # 0 while open
    attrs: Dict = field(default_factory=dict)


@dataclass
class Recording:
    """What one recording window kept."""
    spans: List[SpanRecord] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def _open(self, name, uid, parent, attrs, thread) -> SpanRecord:
        with self._lock:
            r = SpanRecord(len(self.spans), name, uid, parent, thread,
                           attrs=attrs)
            self.spans.append(r)
        return r

    def named(self, name: str) -> List[SpanRecord]:
        return [r for r in self.spans if r.name == name]


_recording: Optional[Recording] = None
_local = threading.local()


def _stack() -> List[Tuple[Recording, int]]:
    """This thread's open spans (and, once, its native id: a system call
    that costs tens of microseconds on some hosts)."""
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
        _local.tid = threading.get_native_id()
    return s


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP = _Noop()


class _Timer:
    """An off ``timed`` span: the host clock around the block."""
    __slots__ = ("_t0", "seconds")

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0


class _Span:
    __slots__ = ("_rec", "_args", "_rf", "record", "seconds")

    def __init__(self, rec: Recording, name, uid, parent, attrs):
        self._rec, self._args = rec, (name, uid, parent, attrs)

    def __enter__(self):
        name, uid, parent, attrs = self._args
        stack = _stack()
        if parent is None and stack and stack[-1][0] is self._rec:
            parent = stack[-1][1]
        r = self.record = self._rec._open(name, uid, parent, attrs,
                                          _local.tid)
        stack.append((self._rec, r.id))
        self._rf = torch.profiler.record_function(PREFIX + name)
        r.start_ns = time.time_ns()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        r = self.record
        r.end_ns = time.time_ns()
        _stack().pop()
        self.seconds = (r.end_ns - r.start_ns) * 1e-9


def span(name: str, uid: Optional[int] = None, *,
         parent: Optional[int] = None, **attrs):
    """A layer boundary (``SPANS``); a shared no-op unless recording."""
    rec = _recording
    if rec is None:
        return _NOOP
    return _Span(rec, name, uid, parent, attrs)


def timed(name: str, **attrs):
    """A span whose ``seconds`` hold its wall after the block, recording
    or not (off: ``time.perf_counter`` around the block)."""
    rec = _recording
    if rec is None:
        return _Timer()
    return _Span(rec, name, None, None, attrs)


def current() -> Optional[int]:
    """The innermost open span's id on this thread (None when off)."""
    rec = _recording
    stack = _stack() if rec is not None else None
    if not stack or stack[-1][0] is not rec:
        return None
    return stack[-1][1]


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span of the block's window, on every thread, into
    the yielded :class:`Recording`."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already on")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
