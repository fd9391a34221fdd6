"""The work of each hand-written kernel, and the counters that record it.

One function per kernel returns ``{"flops", "bytes"}`` for one call from
its shapes: the bytes are the least the call must move (each input read
once, each output written once), the flops the arithmetic it must do.  The
same numbers give a kernel's bound in ``chip_smoke.py`` (bytes over the
card's memory rate, flops over its peak), and what the dry run and the
roofline (``launch/dryrun.py``, ``launch/roofline.py``) count for a call.
Where the work depends on the data -- the K/V rows a decode reads, the rows
``masked_compact`` keeps, the rows and experts ``grouped_ffn`` is handed
through ``counts`` (``grouped_ffn_sorted`` through its offsets) -- the
caller passes what this call's data needs; left out, the most the shapes
allow is counted (what a meta tensor, which holds no data, can say).

A kernel is launched through its ``ctypes`` binding, not as a PyTorch
operator, so no dispatch mode sees it.  Instead each launch on the card,
and each call on the meta device (which stands for the card), records its
name and cost in every active :class:`KernelCounter` (:func:`counting`),
through :func:`counted`, which runs the call with the dispatch modes
suspended: its own allocations and reads are the kernel's, already in the
cost, and counting the cost needs no more than the shapes (and, on the
card, a read of the lengths or counts, made only while a counter is
active).

:func:`trips` serves loops whose every trip has the same shapes, run on
the meta device with no gradient recorded (:func:`once`): two trips run
and every active counter scales what it recorded in the second by the
trips left (:func:`repeats`) -- the same totals as running every trip,
which on the meta device would only repeat the same shape arithmetic; the
second trip sees the first one's leftovers live, as every later trip
does.  The trips' outputs that the loop keeps (a list joined after it) are
:func:`stand_ins` for the trips that do not run, made before those that
do, so the live bytes are those of the last real trip.  Where a gradient
is recorded every trip runs (its backward would see only the trips that
ran).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

Cost = Dict[str, float]


def _cost(flops, n_bytes) -> Cost:
    return {"flops": flops, "bytes": n_bytes}     # ints stay ints


def decode_attention(B: int, H: int, Hkv: int, dh: int, rows: int,
                     esize: int, *, start: bool = False,
                     lse: bool = False) -> Cost:
    """One GQA decode call over ``rows`` K/V rows in all, summed over the
    ``B`` slots (each slot's rows in its window): the K and V rows read, q
    read and the output written, the int32 lengths (and ``start``) read,
    the f32 ``lse`` [B, H] written; q.k and p.v, 2 flops a multiply-add."""
    n_bytes = (2 * rows * Hkv * dh * esize          # K and V rows read
               + 2 * B * H * dh * esize             # q read, out written
               + 4 * B                              # cache_len
               + (4 * B if start else 0)
               + (4 * B * H if lse else 0))
    return _cost(4 * H * rows * dh, n_bytes)


def prefill_attention(B: int, Sq: int, Sk: int, H: int, Hkv: int, dh: int,
                      causal: bool, window: int, esize: int = 2,
                      dv: Optional[int] = None) -> Cost:
    """One GQA prefill-attention call with a prefill's positions (query i
    at ``Sk - Sq + i``, key j at j: a prompt, or its tail resumed after
    ``Sk - Sq`` cached rows): q . k (width ``dh``) and p . v (width ``dv``,
    ``dh`` unless given: MLA's prefill) over the query-key pairs the mask
    leaves (causal: keys at or before the query; with a window, less than
    ``window`` before it), 2 flops a multiply-add, P . V counted once; q, k
    and v read and the output written once."""
    dv = dh if dv is None else dv
    pairs = 0
    for p in range(Sk - Sq, Sk):
        hi = min(p, Sk - 1) if causal else Sk - 1
        lo = max(p - window + 1, 0) if window else 0
        pairs += max(hi - lo + 1, 0)
    n_bytes = esize * (B * Sq * H * (dh + dv) + B * Sk * Hkv * (dh + dv))
    return _cost(2 * B * H * (dh + dv) * pairs, n_bytes)


def mla_decode_attention(B: int, H: int, width: int, v_dim: int, rows: int,
                         esize: int = 2) -> Cost:
    """One MLA decode call over ``rows`` latent rows in all, summed over
    the ``B`` slots (each slot's rows below its length): each row read
    once, whole (it is the key, its first ``v_dim`` values the value), the
    absorbed q [B,H,width] read and the output [B,H,v_dim] written, the
    int32 lengths read; q . row and p . v, 2 flops a multiply-add."""
    n_bytes = (rows * width * esize
               + B * H * (width + v_dim) * esize
               + 4 * B)
    return _cost(2 * H * rows * (width + v_dim), n_bytes)


def masked_compact(B: int, S: int, D: int, K: int, esize: int,
                   kept: Optional[int] = None) -> Cost:
    """One compaction of ``tokens [B,S,D]`` into ``K`` slots: the mask read,
    the ``kept`` rows read (default: every row that fits, ``B*min(S,K)``),
    ``out [B,K,D]``, ``idx [B,K]`` and ``count [B]`` written; no
    arithmetic."""
    kept = B * min(S, K) if kept is None else kept
    return _cost(0, B * S + kept * D * esize + B * K * D * esize
                 + B * K * 4 + B * 4)


def grouped_ffn(E: int, C: int, D: int, F: int, esize: int, *,
                routed_rows: Optional[float] = None,
                experts_used: Optional[float] = None,
                counts: bool = False) -> Cost:
    """One per-expert SwiGLU over ``buf [E,C,D]``: the routed rows read
    (default all ``E*C``), ``out [E,C,D]`` written, the weights of the
    experts used (default all ``E``) read once, the int32 ``counts`` [E]
    when given; three products over the routed rows."""
    rows = E * C if routed_rows is None else routed_rows
    used = E if experts_used is None else experts_used
    n_bytes = esize * (rows * D + E * C * D + used * 3 * D * F) \
        + (4 * E if counts else 0)
    return _cost(6 * rows * D * F, n_bytes)


def grouped_ffn_sorted(rows: int, E: int, D: int, F: int, esize: int, *,
                       experts_used: Optional[float] = None) -> Cost:
    """One per-expert SwiGLU over ``rows`` expert-sorted rows ``[rows, D]``:
    the rows read and the output ``[rows, D]`` written once, the weights of
    the experts used (default all ``E``) read once, the int32 offsets
    ``[E+1]``; three products over the rows."""
    used = E if experts_used is None else experts_used
    n_bytes = esize * (2 * rows * D + used * 3 * D * F) + 4 * (E + 1)
    return _cost(6 * rows * D * F, n_bytes)


def ssm_scan(B: int, S: int, di: int, N: int) -> Cost:
    """One recurrence over ``[B,S,di,N]`` f32: decay and bx read, h_all
    written, h0 read, h_last written; a multiply and an add an element."""
    C = di * N
    return _cost(2 * B * S * C, 4 * B * C * (3 * S + 2))


def ssm_scan_bwd(B: int, S: int, di: int, N: int, *, G: bool = True,
                 g: bool = False) -> Cost:
    """The recurrence's backward over ``[B,S,di,N]`` f32: decay, h_all and
    h0 read, the gradients of h_all (``G``) and h_last (``g``) read when
    given, d_decay, d_bx and d_h0 written; three flops an element."""
    C = di * N
    n_bytes = 4 * B * C * (2 * S + 1 + (S if G else 0) + (1 if g else 0)
                           + 2 * S + 1)
    return _cost(3 * B * S * C, n_bytes)


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------
class KernelCounter:
    """Calls, flops and bytes of the kernels recorded while it is active,
    by kernel name."""

    def __init__(self):
        self.calls: Dict[str, float] = {}
        self.flops: Dict[str, float] = {}
        self.bytes: Dict[str, float] = {}
        self._marks: list = []

    def kernel(self, name: str, cost: Cost, outputs=()) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.flops[name] = self.flops.get(name, 0.0) + cost["flops"]
        self.bytes[name] = self.bytes.get(name, 0.0) + cost["bytes"]

    def begin_repeat(self, n: int) -> None:
        self._marks.append((n, dict(self.calls), dict(self.flops),
                            dict(self.bytes)))

    def end_repeat(self) -> None:
        n, *before = self._marks.pop()
        for now, then in zip((self.calls, self.flops, self.bytes), before):
            for k in now:
                now[k] += (n - 1) * (now[k] - then.get(k, 0))

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {"calls", "flops", "bytes"}}, names sorted."""
        return {k: {"calls": self.calls[k], "flops": self.flops[k],
                    "bytes": self.bytes[k]} for k in sorted(self.calls)}

    def sum(self, what: str) -> float:
        return float(sum(getattr(self, what).values()))


_ACTIVE: list = []     # counters: KernelCounter and the profiling modes


def counting_active() -> bool:
    """Whether a counter records the kernels called now."""
    return bool(_ACTIVE)


@contextmanager
def counting(counter=None):
    """Make ``counter`` (default: a new :class:`KernelCounter`) record the
    kernels called inside the block; yields it.  Any object with
    ``kernel(name, cost, outputs)``, ``begin_repeat(n)`` and
    ``end_repeat()`` may count."""
    counter = KernelCounter() if counter is None else counter
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.remove(counter)


_TALLY = threading.local()   # this thread's calls by name (:func:`tallying`)


@contextmanager
def tallying():
    """Count the kernel calls this thread makes inside the block, by name;
    yields the dict.  Another thread's calls meanwhile are not counted
    (``serving/decode_graph.py`` captures a decode step while the
    engine's prefill thread launches)."""
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = counts = {}
    try:
        yield counts
    finally:
        _TALLY.counts = outer


def counted(name: str, run: Callable, cost: Callable[..., Cost]):
    """``run()``, a kernel call on the card or its meta stand-in, recorded
    as ``name`` with ``cost(outputs)`` in every active counter, and in this
    thread's tally (:func:`tallying`).  While a counter is active the call
    runs with the dispatch modes suspended, so its own allocations and
    reads (and the cost's) are not counted as operators."""
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
    if not _ACTIVE:
        return run()
    with _disable_current_modes():
        out = run()
        c = cost(out)
    for counter in list(_ACTIVE):
        counter.kernel(name, c, out)
    return out


@contextmanager
def repeats(n: int):
    """Count what runs inside the block ``n`` times over (module
    docstring): for loops on the meta device whose trips all have the same
    shapes."""
    live = list(_ACTIVE)
    for counter in live:
        counter.begin_repeat(n)
    try:
        yield
    finally:
        for counter in reversed(live):
            counter.end_repeat()


def trips(n: int, once_: bool):
    """The trip indices of an ``n``-trip loop to run: all of them, or with
    ``once_`` (:func:`once`) the first two, the second counted for the
    ``n - 1`` after the first (module docstring)."""
    if not once_ or n <= 2:
        yield from range(n)
        return
    yield 0
    with repeats(n - 1):
        yield 1


def ran(n: int, once_: bool) -> int:
    """How many of an ``n``-trip loop's trips :func:`trips` runs."""
    return min(n, 2) if once_ else n


def once(*tensors: torch.Tensor) -> bool:
    """Whether a loop over these tensors may run two trips for all
    (:func:`trips`): they are on the meta device and no gradient is
    recorded through them."""
    return tensors[0].is_meta and not (
        torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def stand_ins(n: int, shape, dtype, device) -> list:
    """``n`` empty tensors standing for the outputs a loop keeps from the
    trips :func:`repeats` does not run: made with the dispatch modes
    suspended (no operator ran) and counted as allocated by every active
    counter that tracks memory."""
    with _disable_current_modes():
        made = [torch.empty(shape, dtype=dtype, device=device)
                for _ in range(n)]
    for counter in list(_ACTIVE):
        allocated = getattr(counter, "allocated", None)
        if allocated is not None:
            allocated(made)
    return made
