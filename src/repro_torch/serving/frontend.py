"""Asyncio serving ingress: multi-tenant SLO scheduling ahead of
:class:`~repro_torch.core.topology.HeteroRuntime`.

* **streaming requests** — ``submit()`` returns a :class:`TokenStream`
  that yields tokens as they land on the host (the engines' per-run
  ``on_tokens`` hook), with TTFT/ITL stamped at arrival.
* **per-tenant deadline/priority classes** — admission order is the
  :class:`~repro_torch.core.scheduler.TenantScheduler`'s weighted deficit
  round-robin with deadline-class preemption; no tenant starves.
* **bounded-queue backpressure** — the admission queue is bounded by
  ``queue_depth``; a full queue refuses with :class:`QueueFullError`
  before any work is queued (typed, never silent).
* **power/busy-factor-aware shedding** — the runtime's
  :class:`~repro_torch.core.admission.AdmissionController` re-routes load
  off budget-hot groups via the masked-simplex split; when the WHOLE fleet
  runs hot, re-routing has nowhere to go, so the ingress sheds instead:
  submissions beyond ``shed_depth`` are refused with
  :class:`RequestShedError` while ``fleet_hot()``.

The scheduler loop feeds the continuous engines at wave boundaries: each
iteration selects one wave of requests and runs ``runtime.serve`` for it
on a worker thread, streaming tokens back through the event loop.  Chaos
contract: every ACCEPTED request either completes bit-identically on
surviving groups (replays after a mid-wave group kill are deduplicated by
stream position, which bit-identity makes sound) or, when every decode
group is dead, fails with a typed :class:`RequestAbortedError`; REFUSED
requests never stream a token.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.offload import GroupUnavailableError
from repro_torch.core.scheduler import TenantClass, TenantScheduler
from repro_torch.serving import engine as _engine

if TYPE_CHECKING:
    from repro_torch.serving.engine import RequestOutput, ServeRequest


class FrontendError(RuntimeError):
    """Typed ingress refusal — raised BEFORE any token streams."""

    def __init__(self, tenant: str, msg: str):
        super().__init__(f"[tenant {tenant}] {msg}")
        self.tenant = tenant


class QueueFullError(FrontendError):
    """Bounded-queue backpressure: the admission queue is at depth."""


class RequestShedError(FrontendError):
    """Power/memory admission shed: every decode group's budget is hot
    and the queue already holds ``shed_depth`` requests."""


class RequestAbortedError(FrontendError):
    """The fleet died with the request accepted but unservable."""


@dataclass
class _Entry:
    uid: int
    tenant: str
    task: str
    request: ServeRequest
    stream: "TokenStream"
    t_submit: float
    streamed: int = 0            # tokens already pushed (dedupe position)
    t_first: float = -1.0
    t_last: float = -1.0


class TokenStream:
    """Async view of one request's token stream.

    ``async for tok in stream`` yields ints as they land; ``collect()``
    drains to the final np.int32 array.  A typed refusal/abort raises
    out of the iterator.  TTFT/ITL are stamped by the frontend at
    arrival time and exposed on the stream after completion."""

    def __init__(self, uid: int, tenant: str,
                 loop: asyncio.AbstractEventLoop):
        self.uid = uid
        self.tenant = tenant
        self._q: asyncio.Queue = asyncio.Queue()
        self._loop = loop
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.done = False
        self.ttft_s: float = -1.0
        self.itl_s: List[float] = []   # per-token inter-arrival samples

    # -- producer side (event-loop thread only) -----------------------
    def _push(self, toks: List[int]) -> None:
        self.tokens.extend(toks)
        self._q.put_nowait(list(toks))

    def _finish(self, err: Optional[BaseException] = None) -> None:
        self.error = err
        self.done = True
        self._q.put_nowait(None)

    # -- consumer side ------------------------------------------------
    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        while True:
            item = await self._q.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            for t in item:
                yield t

    async def collect(self) -> np.ndarray:
        async for _ in self:
            pass
        return np.asarray(self.tokens, np.int32)


@dataclass
class TenantStats:
    submitted: int = 0
    accepted: int = 0
    completed: int = 0
    refused_queue: int = 0       # QueueFullError backpressure refusals
    shed: int = 0                # RequestShedError power/memory sheds
    aborted: int = 0             # accepted but fleet died
    max_queue_depth: int = 0
    ttft_s: List[float] = field(default_factory=list)
    itl_s: List[float] = field(default_factory=list)


def _pctl(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else 0.0


class ServingFrontend:
    """Asyncio ingress in front of a task-registered ``HeteroRuntime``.

        rt = HeteroRuntime(topo, ...); rt.add_task("chat", cfg, params)
        fe = ServingFrontend(rt, tenants={
            "interactive": TenantClass("interactive", priority=0,
                                       weight=2.0, deadline_s=0.5),
            "batch": TenantClass("batch", priority=1, weight=1.0)})
        await fe.start()
        stream = await fe.submit(prompt, max_new=16, tenant="interactive")
        async for tok in stream: ...
        await fe.stop()

    One serve wave at a time: the loop selects up to ``wave_requests``
    requests (tenant-fair, urgent-class first), dispatches them through
    ``runtime.serve`` on a worker thread (wave boundaries ARE the
    engine's admission boundaries), and streams tokens back as the
    engines land them on the host.  ``split`` pins the wave split for
    deterministic schedules (tests); None leaves the online controller
    in charge."""

    def __init__(self, runtime, tenants: Dict[str, TenantClass], *,
                 queue_depth: int = 64,
                 shed_depth: Optional[int] = None,
                 wave_requests: Optional[int] = None,
                 split=None, quantum: float = 1.0):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.runtime = runtime
        self.tenants = dict(tenants)
        self.queue_depth = int(queue_depth)
        # under a fleet-hot budget the ingress admits only this much
        # backlog before shedding (default: one wave's worth)
        self.shed_depth = int(shed_depth) if shed_depth is not None \
            else max(runtime.slots, 1)
        self.wave_requests = int(wave_requests) if wave_requests \
            else 2 * runtime.slots * max(len(runtime._decode) - 1, 1)
        self.split = split
        self.sched = TenantScheduler(self.tenants, quantum=quantum)
        self.stats: Dict[str, TenantStats] = {
            t: TenantStats() for t in self.tenants}
        self.waves_served = 0
        # wave-clock accounting summed across serve calls: each wave's
        # totals are folded in exactly once, so a frontend-admitted
        # request never double-counts in wave_requeued/admission_stalls
        self.runtime_totals: Dict[str, int] = {
            "wave_requeued": 0, "wave_retries": 0,
            "admission_stalls": 0, "admission_rerouted": 0, "tokens": 0}
        self._uid = 0
        self._live: Dict[int, _Entry] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._running = False
        self._stream = None       # the loop thread's CUDA stream at start()

    # -- lifecycle ----------------------------------------------------
    async def start(self) -> None:
        if self._running:
            return
        self._loop = asyncio.get_running_loop()
        dev = self._device()
        self._stream = torch.cuda.current_stream(dev) \
            if dev.type == "cuda" else None
        self._wake = asyncio.Event()
        self._running = True
        self._task = asyncio.create_task(self._serve_loop())

    async def stop(self) -> None:
        """Drain the backlog, then stop the loop."""
        if not self._running:
            return
        self._running = False
        self._wake.set()
        await self._task
        self._task = None

    # -- ingress ------------------------------------------------------
    async def submit(self, prompt: np.ndarray, max_new: int, *,
                     tenant: str, task: str = "",
                     frontend=None) -> TokenStream:
        """Accept one streaming request.  Raises typed
        :class:`QueueFullError` / :class:`RequestShedError` refusals
        BEFORE any work is queued — a refused request never streams."""
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r} "
                           f"(have {sorted(self.tenants)})")
        if not self._running:
            raise RuntimeError("frontend is not running — call start()")
        st = self.stats[tenant]
        st.submitted += 1
        backlog = self.sched.backlog()
        if backlog >= self.queue_depth:
            st.refused_queue += 1
            raise QueueFullError(
                tenant, f"admission queue at depth {backlog} "
                        f"(queue_depth={self.queue_depth})")
        if backlog >= self.shed_depth and self.runtime.admission.fleet_hot():
            # every decode group's power/memory budget is hot: re-routing
            # has nowhere to go, so shed instead of admitting blindly
            st.shed += 1
            raise RequestShedError(
                tenant, f"fleet power/memory budget hot with {backlog} "
                        f"queued (shed_depth={self.shed_depth})")
        self._uid += 1
        uid = self._uid
        stream = TokenStream(uid, tenant, self._loop)
        req = _engine.ServeRequest(uid=uid, prompt=np.asarray(prompt, np.int32),
                           max_new=int(max_new), frontend=frontend,
                           task=task)
        entry = _Entry(uid=uid, tenant=tenant, task=task, request=req,
                       stream=stream, t_submit=time.perf_counter())
        self._live[uid] = entry
        depth = self.sched.enqueue(tenant, entry)
        st.accepted += 1
        st.max_queue_depth = max(st.max_queue_depth, depth)
        self._wake.set()
        return stream

    # -- streaming plumbing -------------------------------------------
    def _on_tokens(self, uid: int, start: int, toks: List[int]) -> None:
        """Engine hook — called on the serve WORKER thread; hop onto the
        event loop before touching streams."""
        self._loop.call_soon_threadsafe(self._push_tokens, uid, start,
                                        toks)

    def _push_tokens(self, uid: int, start: int, toks: List[int]) -> None:
        entry = self._live.get(uid)
        if entry is None or entry.stream.done:
            return
        # positional dedupe: a re-queued request replayed on a survivor
        # re-emits from position 0 — bit-identity makes the overlap
        # byte-equal, so only the unseen suffix streams
        if start + len(toks) <= entry.streamed:
            return
        fresh = toks[entry.streamed - start:] if start < entry.streamed \
            else toks
        now = time.perf_counter()
        if entry.streamed == 0:
            entry.t_first = now
            entry.stream.ttft_s = now - entry.t_submit
            self.stats[entry.tenant].ttft_s.append(entry.stream.ttft_s)
            if len(fresh) > 1:
                gap = 0.0   # same-arrival tokens: zero inter-token gap
                entry.stream.itl_s.extend([gap] * (len(fresh) - 1))
                self.stats[entry.tenant].itl_s.extend(
                    [gap] * (len(fresh) - 1))
        else:
            gap = (now - entry.t_last) / len(fresh)
            entry.stream.itl_s.extend([gap] * len(fresh))
            self.stats[entry.tenant].itl_s.extend([gap] * len(fresh))
        entry.t_last = now
        entry.streamed += len(fresh)
        entry.stream._push(fresh)

    def _finish_entry(self, entry: _Entry, out: RequestOutput) -> None:
        tail = [int(t) for t in out.tokens[entry.streamed:]]
        if tail:
            self._push_tokens(entry.uid, entry.streamed, tail)
        self.stats[entry.tenant].completed += 1
        entry.stream._finish()
        del self._live[entry.uid]

    def _abort_entry(self, entry: _Entry, msg: str) -> None:
        self.stats[entry.tenant].aborted += 1
        entry.stream._finish(RequestAbortedError(entry.tenant, msg))
        del self._live[entry.uid]

    # -- the wave loop ------------------------------------------------
    def _device(self) -> torch.device:
        return torch.device(self.runtime.topology.hub.devices[0])

    def _serve_wave(self, reqs: List[ServeRequest]):
        """One ``runtime.serve`` on the executor thread.  PyTorch keeps the
        current device, the current stream and grad mode per thread: the
        wave runs with the hub's device current, under ``no_grad``, on the
        stream that was current on the event loop's thread at ``start()``
        (so the wave's work queues behind what the caller enqueued there,
        and the engines' side streams wait on it as on any caller's)."""
        dev = self._device()
        with torch.no_grad():
            if self._stream is None:
                return self.runtime.serve(reqs, split=self.split,
                                          wave=len(reqs), warm=False,
                                          on_tokens=self._on_tokens)
            torch.cuda.set_device(dev)
            with torch.cuda.stream(self._stream):
                return self.runtime.serve(reqs, split=self.split,
                                          wave=len(reqs), warm=False,
                                          on_tokens=self._on_tokens)

    async def _serve_loop(self) -> None:
        loop = self._loop
        while self._running or self.sched.backlog():
            if not self.sched.backlog():
                self._wake.clear()
                if not self._running:
                    break
                await self._wake.wait()
                continue
            picked = self.sched.select(self.wave_requests)
            entries = [e for _, e in picked]
            reqs = [e.request for e in entries]
            try:
                result = await loop.run_in_executor(
                    None, self._serve_wave, reqs)
            except GroupUnavailableError as e:
                # every decode group is dead: typed abort for the whole
                # wave (requests with a live stream get the same error —
                # their tokens can no longer complete)
                for entry in entries:
                    self._abort_entry(entry, f"fleet unavailable: {e}")
                continue
            self.waves_served += 1
            tot = result.telemetry["totals"]
            for k in self.runtime_totals:
                self.runtime_totals[k] += int(tot.get(k, 0))
            by_uid = {o.uid: (task, o)
                      for task, outs in result.outputs.items()
                      for o in outs}
            for entry in entries:
                hit = by_uid.get(entry.uid)
                if hit is None:      # defensive: serve dropped a request
                    self._abort_entry(entry, "request lost in serve wave")
                    continue
                self._finish_entry(entry, hit[1])

    # -- telemetry ----------------------------------------------------
    def telemetry(self) -> dict:
        """Per-tenant SLO telemetry: TTFT/ITL percentiles (seconds),
        queue/shed/abort counters.  Shape-stable for the golden schema:
        every field exists for every tenant from construction."""
        per_tenant = {}
        for name in sorted(self.tenants):
            st = self.stats[name]
            tc = self.tenants[name]
            per_tenant[name] = {
                "priority": tc.priority, "weight": tc.weight,
                "deadline_s": tc.deadline_s,
                "submitted": st.submitted, "accepted": st.accepted,
                "completed": st.completed,
                "refused_queue": st.refused_queue, "shed": st.shed,
                "aborted": st.aborted,
                "max_queue_depth": st.max_queue_depth,
                "ttft_p50_s": _pctl(st.ttft_s, 50.0),
                "ttft_p99_s": _pctl(st.ttft_s, 99.0),
                "itl_p50_s": _pctl(st.itl_s, 50.0),
                "itl_p99_s": _pctl(st.itl_s, 99.0),
            }
        return {"queue_depth": self.queue_depth,
                "shed_depth": self.shed_depth,
                "wave_requests": self.wave_requests,
                "waves_served": self.waves_served,
                "backlog": self.sched.backlog(),
                "runtime": dict(self.runtime_totals),
                "tenants": per_tenant}
