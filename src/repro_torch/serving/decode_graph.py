"""One decode step of the fused loop as a chain of CUDA graphs that break
at the decode-attention calls.

``make_decode_loop`` (``serving/engine.py``) runs its K steps through a
:class:`DecodeGraphs` wherever :func:`decode_graph_refusal` names no
reason.  Launched op by op, a step costs the host some 80 launches a
layer, several times the device's time for the step.  A step is
``M.forward(mode="decode")``, the greedy argmax and the in-place update of
the four decode-state vectors.  It is captured as one CUDA graph for each
stretch between two decode-attention calls (``models/attention.py:
decode_break``), all in one memory pool, on a side stream in thread-local
capture mode, so that another thread's work cannot spoil a capture.  The
attention calls stay eager: their wrappers keep host state per call (the
split workspace, the tickets kept per stream), and a wrapper put on the
module later, such as a profiler's span, must still see each call.

A replay of a step replays segment 0, then for each break calls the
module's function by name (looked up at every replay) with the captured
arguments, copies its result into the tensor the next segment reads, and
replays that segment.  The graphs read the params, the cache and the
runner's own copies of the state vectors at the addresses they had at
capture: the runner copies the caller's vectors in and out once a
macro-step, and captures again, counted, when a param or cache leaf has
moved or the batch has changed.  The continuous engine takes its decode
cache from :meth:`DecodeGraphs.cache`, made once for the loop its engines
share and zeroed for each run, so its addresses hold by construction.

Each capture follows one eager step, which runs the lazy set-up a capture
may not (the kernels' library, cuBLAS's workspace on the capture stream)
and records each break's output.  The capture runs no attention call: the
next segment reads an empty tensor of the recorded shape, which every
replay fills.  The kernel calls this thread makes while the segments are
captured (``costs.tallying``) are taken back from the wrappers' launch
counts after the capture and added on each replay, so
``ops.launch_counts()`` reads what an eager run reads, whatever another
thread launches meanwhile.

The graphs keep alive every break's arguments, which an eager step frees
layer by layer: a few small tensors a layer.  The int8 cache's breaks
take its int8 leaves and scales (``attention.decode_attend_int8``), so its
f32 copies live only inside the eager call.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.offload import tree_leaves
from repro_torch.kernels import costs, ops
from repro_torch.models import attention, sharding


def decode_graph_refusal(t: torch.Tensor, use_kernels: bool) -> Optional[str]:
    """Why the decode step of ``t``'s batch (any tensor of its state) runs
    eagerly, or None where it runs as graphs."""
    if not use_kernels:
        return "kernels are off"
    if sharding.active_mesh() is not None:
        return "a mesh is active: its collectives cannot be captured"
    if torch.is_grad_enabled():
        return "grad is enabled"
    if costs.counting_active():
        return "a cost counter is active: it counts operators as they run"
    if not t.is_cuda:
        return f"not a CUDA device: {t.device}"
    return None


class _CudaCapture:
    """CUDA graphs on a side stream of ``device``, all in one pool."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    @contextlib.contextmanager
    def side(self):
        """Run the block on the side stream, ordered after the current
        stream's work and before its later work."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            yield
        cur.wait_stream(self.stream)

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def end(self) -> Callable[[], None]:
        """End the segment begun last; returns its replay."""
        graph, self._graph = self._graph, None
        graph.capture_end()
        return graph.replay

    def capturing(self) -> bool:
        return self._graph is not None


class _Break(NamedTuple):
    name: str               # the models.attention function
    args: tuple
    kw: dict
    out: torch.Tensor       # what the next segment reads


class _Plan(NamedTuple):
    """One captured step: segment i, then break i, then segment i + 1."""
    key: tuple
    state: Tuple[torch.Tensor, ...]    # the graphs' state vectors
    segments: List[Callable[[], None]]
    breaks: List[_Break]
    launches: Dict[str, int]           # what the segments launch a step
    pool: Any                          # the graphs' memory pool


def _key(params, cache, cur_tok: torch.Tensor) -> tuple:
    """What the graphs' addresses hang on: the batch and every param and
    cache leaf's place, shape and dtype."""
    return (tuple(cur_tok.shape), cur_tok.device) + tuple(
        (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
        for t in tree_leaves((params, cache)) if torch.is_tensor(t))


class DecodeGraphs:
    """The decode step ``step(params, cache, cur_tok, lengths, remaining,
    done)`` (in place) run as graphs, captured again when its key moves.

    ``graph_steps``, ``eager_steps`` (the loop's refused steps and each
    capture's eager step) and ``captures`` count since construction;
    ``capture_s`` is the host seconds the captures took, eager steps
    included."""

    COUNTS = ("decode_graph_steps", "decode_eager_steps",
              "decode_graph_captures")

    def __init__(self, step: Callable):
        self._step = step
        self._plan: Optional[_Plan] = None
        self._cache: Optional[Tuple[Any, Any]] = None   # (its key, cache)
        self.graph_steps = self.eager_steps = self.captures = 0
        self.capture_s = 0.0

    def cache(self, key, make: Callable[[], Any]):
        """A zeroed decode cache for a run through the graphs: ``make()``'s
        where ``key`` (what the cache's shapes hang on) is new, else the
        last run's, zeroed, at the addresses the graphs read.  A new cache
        drops the graphs and the cache they read first, so that two never
        live at once."""
        if self._cache is not None and self._cache[0] == key:
            for t in tree_leaves(self._cache[1]):
                if torch.is_tensor(t):
                    t.zero_()
            return self._cache[1]
        self._drop()
        self._cache = None           # freed before the new one is made
        self._cache = (key, make())
        return self._cache[1]

    def _drop(self) -> None:
        """Drop the plan, once the work queued on its graphs is done."""
        if self._plan is not None:
            dev = self._plan.state[0].device
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            self._plan = None

    @property
    def pool(self):
        """The current graphs' memory pool (None before a capture)."""
        return None if self._plan is None else self._plan.pool

    def counts(self) -> Dict[str, int]:
        """The counters under ``ContinuousStats``' names."""
        return dict(zip(self.COUNTS, (self.graph_steps, self.eager_steps,
                                      self.captures)))

    def run(self, K: int, params, cache, cur_tok, lengths, remaining,
            done) -> torch.Tensor:
        """K steps from the caller's state vectors, updated in place;
        returns the tokens [K, B]."""
        vecs = (cur_tok, lengths, remaining, done)
        key = _key(params, cache, cur_tok)
        if self._plan is not None and self._plan.key != key:
            self._drop()
        plan = self._plan
        state = plan.state if plan is not None \
            else tuple(torch.empty_like(v) for v in vecs)
        for s, v in zip(state, vecs):
            s.copy_(v)
        toks = torch.empty((K, cur_tok.shape[0]), dtype=torch.int32,
                           device=cur_tok.device)
        first = 0
        if plan is None:
            plan = self._plan = self._capture(key, params, cache, state, toks)
            first = 1
        for i in range(first, K):
            with tracing.span("model.decode_step"):
                self._replay(plan)
                toks[i] = state[0]
        self.graph_steps += K - first
        for v, s in zip(vecs, state):
            v.copy_(s)
        return toks

    @staticmethod
    def _replay(plan: _Plan) -> None:
        plan.segments[0]()
        for (name, args, kw, out), seg in zip(plan.breaks,
                                              plan.segments[1:]):
            out.copy_(getattr(attention, name)(*args, **kw))
            seg()
        ops.count_launches(plan.launches)

    def _capture(self, key, params, cache, state, toks) -> _Plan:
        """One eager step (the loop's first: its tokens go to ``toks[0]``)
        that records each break's output, then the step's capture."""
        t0 = time.perf_counter()
        cap = _CudaCapture(state[0].device)
        outs: List[Tuple[str, torch.Tensor]] = []

        def record(name, args, kw):
            out = getattr(attention, name)(*args, **kw)
            outs.append((name, out))
            return out

        with cap.side():
            with tracing.span("model.decode_step"), _recorder(record):
                self._step(params, cache, *state)
            toks[0] = state[0]
            plan = self._capture_step(key, cap, params, cache, state, outs)
        self.eager_steps += 1
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return plan

    def _capture_step(self, key, cap, params, cache, state, outs) -> _Plan:
        segments: List[Callable[[], None]] = []
        breaks: List[_Break] = []

        def at_break(name, args, kw):
            segments.append(cap.end())
            if len(breaks) >= len(outs) or outs[len(breaks)][0] != name:
                raise RuntimeError(
                    f"decode graph capture: break {len(breaks)} calls "
                    f"{name}, the eager step's called "
                    f"{[n for n, _ in outs][len(breaks):len(breaks) + 1]}")
            like = outs[len(breaks)][1]
            out = torch.empty_strided(like.shape, like.stride(),
                                      dtype=like.dtype, device=like.device)
            breaks.append(_Break(name, args, kw, out))
            cap.begin()
            return out

        cap.begin()
        try:
            with costs.tallying() as launches, _recorder(at_break):
                self._step(params, cache, *state)
        except BaseException:
            if cap.capturing():      # leave capture mode; the error stands
                with contextlib.suppress(RuntimeError):
                    cap.end()
            raise
        segments.append(cap.end())
        if len(breaks) != len(outs):
            raise RuntimeError(f"decode graph capture: {len(breaks)} breaks, "
                               f"the eager step made {len(outs)}")
        # the capture ran none of the segments' launches
        ops.count_launches({k: -n for k, n in launches.items()})
        return _Plan(key, state, segments, breaks, dict(launches), cap.pool)


@contextlib.contextmanager
def _recorder(fn):
    """Route this thread's decode-attention calls to ``fn(name, args,
    kw)`` inside the block."""
    attention._breaks.recorder = fn
    try:
        yield
    finally:
        attention._breaks.recorder = None
