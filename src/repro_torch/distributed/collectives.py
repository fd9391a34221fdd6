"""Collectives on the axes of a :class:`~repro_torch.launch.mesh.Mesh`.

The port runs one process per rank and moves data between ranks with
explicit collectives, where the JAX package's shard_maps name ``psum`` and
GSPMD inserts the rest.  Only two are used on the whole serving path,
``all_reduce`` and ``broadcast``: they are what the gloo backend offers for
CUDA tensors, so the same code runs over gloo (several ranks on one card,
or the CPU) and NCCL (one rank per card).  A gathered tensor (vocab-parallel
logits, a batch shard's rows) goes through ``gather_sum``: a SUM over a
zero-filled buffer holding one slot per rank, which adds only zeros to each
rank's values and so is exact.

Every collective adds the bytes of its result, per rank, to each counter
active on its mesh (:func:`counting`), under the names the JAX package's
HLO parser uses (``serving/profiling.py``), plus ``broadcast``.  A
collective over one rank is the identity: it is not issued and counts
nothing (as XLA drops a psum over an axis of size 1), and neither is any
on a mesh without process groups (one process, no ``torch.distributed``).
On a rank view (``Mesh(view=True)``, the dry run's stand-in for one rank
of a grid) every collective over more than one rank is counted as issued
and moves nothing: the group is :data:`VIEW`.

Training differentiates through the collectives (Megatron-LM's *f* and *g*
operators, and JAX's psum transposes).  On "model" every rank holds the
same copy of the loss; on the batch axes each rank's loss is its own term
of the global mean.  So one sum has a backward that depends on where its
result goes, and each is its own ``torch.autograd.Function``:

====================  ==========================  =======================
function              forward                     backward
====================  ==========================  =======================
``reduce_partial``    sum of rank-partial outputs identity (*g*)
``enter_partial``     identity: a replicated      sum of the gradient (*f*)
                      value entering rank-partial
                      work
``reduce_to_partial`` sum of partial outputs that sum of the gradient
                      feed rank-partial work      (*g* then *f*)
``gather_partial``    ``gather_sum``              this rank's slice
``gather_to_partial`` ``gather_sum`` of blocks    sum of the gradient,
                      feeding rank-partial work   then this rank's slice
``fsdp_gather``       all-gather of a leaf's      reduce-scatter: a sum,
                      FSDP slices                 then this rank's slice
====================  ==========================  =======================

Each is built on ``all_reduce`` alone, so gloo carries CUDA tensors: a
gather sums a zero-filled buffer, a reduce-scatter slices a sum.
``fsdp_gather`` counts as ``"all-gather"`` (the bytes of the gathered
leaf) and its backward as ``"reduce-scatter"`` (the bytes of the shard),
the names the JAX package's HLO parser gives them; the others count as
``"all-reduce"`` wherever they sum.  Off the autograd graph (serving runs
under ``no_grad``) ``reduce_partial`` / ``reduce_to_partial`` are the
in-place ``all_reduce``, ``enter_partial`` is the identity and
``gather_partial`` is ``gather_sum``, so serving issues and counts exactly
what it did.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Sequence

import torch
import torch.distributed as dist

VIEW = object()   # the group of every line of a rank view: counted, not moved

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class CollectiveCounter:
    """Bytes and calls of the collectives issued while it is active, and
    the host wall spent inside them (``seconds``: with gloo on CUDA tensors
    that is the staging through host memory and the exchange)."""

    def __init__(self):
        self.bytes: Dict[str, float] = dict.fromkeys(KINDS, 0.0)
        self.calls: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.seconds = 0.0
        self._marks: list = []

    def add(self, kind: str, n_bytes: float) -> None:
        self.bytes[kind] += float(n_bytes)
        self.calls[kind] += 1

    # a counter of ``kernels/costs.py``: no kernel is a collective; the
    # counts inside ``costs.repeats`` are scaled by its trips
    def kernel(self, name: str, cost, outputs=()) -> None:
        pass

    def begin_repeat(self, n: int) -> None:
        self._marks.append((n, dict(self.bytes), dict(self.calls)))

    def end_repeat(self) -> None:
        n, b0, c0 = self._marks.pop()
        for k in KINDS:
            self.bytes[k] += (n - 1) * (self.bytes[k] - b0[k])
            self.calls[k] += (n - 1) * (self.calls[k] - c0[k])

    def totals(self) -> Dict[str, float]:
        """Bytes by kind and their ``"total"`` (the JAX profile's schema)."""
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        return out


@contextmanager
def counting(mesh):
    """Count the collectives issued on ``mesh`` inside the block."""
    counter = CollectiveCounter()
    mesh.counters.append(counter)
    try:
        yield counter
    finally:
        mesh.counters.remove(counter)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _issue(kind: str, n_bytes: float, mesh, axes: Sequence[str]):
    group = mesh.group(axes)
    if group is None or mesh.axes_size(mesh.canon(axes)) == 1:
        return None
    for counter in mesh.counters:
        counter.add(kind, n_bytes)
    return group


def _spent(mesh, t0: float) -> None:
    dt = time.perf_counter() - t0
    for counter in mesh.counters:
        counter.seconds += dt


def _reduce(t: torch.Tensor, mesh, group, op: str = "sum") -> torch.Tensor:
    if group is not None and group is not VIEW:
        t0 = time.perf_counter()
        dist.all_reduce(t, op=_OPS[op], group=group)
        _spent(mesh, t0)
    return t


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over the ranks that share every coordinate of
    this rank but those on ``axes``; returns ``t``."""
    return _reduce(t, mesh, _issue("all-reduce", _nbytes(t), mesh, axes), op)


def broadcast(t: torch.Tensor, mesh, axes: Sequence[str] = ()) -> torch.Tensor:
    """Overwrite ``t`` in place with its value on the first rank of this
    rank's line along ``axes`` (default: the whole mesh); returns ``t``."""
    axes = tuple(axes) or mesh.axes
    group = _issue("broadcast", _nbytes(t), mesh, axes)
    if group is not None and group is not VIEW:
        t0 = time.perf_counter()
        dist.broadcast(t, src=mesh.line_ranks(axes)[0], group=group)
        _spent(mesh, t0)
    return t


def gather_sum(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` along ``axes`` (n ranks, in
    the first-axis-major order of :meth:`Mesh.linear_index`), by one SUM
    over a zero-filled buffer."""
    n = mesh.axes_size(axes)
    buf = torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
    buf[mesh.linear_index(axes)] = t
    return all_reduce(buf, mesh, axes)


# ---------------------------------------------------------------------------
# Differentiable collectives (the module docstring's table)
# ---------------------------------------------------------------------------
def _summed(g: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A contiguous copy of ``g`` summed over ``axes`` (autograd may share
    the incoming gradient's buffer, so it is never reduced in place)."""
    return all_reduce(g.clone(memory_format=torch.contiguous_format), mesh,
                      axes)


class _ReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce(t.clone(memory_format=torch.contiguous_format),
                          mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh, ctx.axes), None, None


class _ReduceToPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(t.clone(memory_format=torch.contiguous_format),
                          mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh, ctx.axes), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.index = mesh.linear_index(axes)
        return gather_sum(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


class _GatherToPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.index = mesh.linear_index(axes)
        return gather_sum(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh, ctx.axes)[ctx.index], None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        n, i = mesh.axes_size(axes), mesh.linear_index(axes)
        k = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * k
        buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
        buf.narrow(dim, i * k, k).copy_(t)
        ctx.mesh, ctx.axes, ctx.dim, ctx.i, ctx.k = mesh, axes, dim, i, k
        return _reduce(buf, mesh, _issue("all-gather", _nbytes(buf), mesh, axes))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.clone(memory_format=torch.contiguous_format)
        group = _issue("reduce-scatter", _nbytes(g) // mesh.axes_size(ctx.axes),
                       mesh, ctx.axes)
        _reduce(g, mesh, group)
        shard = g.narrow(ctx.dim, ctx.i * ctx.k, ctx.k)
        return shard.clone(memory_format=torch.contiguous_format), None, None, None


def _on_graph(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def reduce_partial(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """*g*: the sum over ``axes`` of rank-partial outputs, a replicated
    result; the gradient passes through unchanged.  Off the autograd graph
    the in-place :func:`all_reduce`."""
    if _on_graph(t):
        return _ReducePartial.apply(t, mesh, tuple(axes))
    return all_reduce(t, mesh, axes)


def enter_partial(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """*f*: a value replicated over ``axes`` entering rank-partial work,
    unchanged; its gradient is summed over ``axes``."""
    if _on_graph(t):
        return _EnterPartial.apply(t, mesh, tuple(axes))
    return t


def reduce_to_partial(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum over ``axes`` of rank-partial outputs that feed rank-partial
    work again (*g* followed by *f*): the gradient is summed too.  Off the
    autograd graph the in-place :func:`all_reduce`."""
    if _on_graph(t):
        return _ReduceToPartial.apply(t, mesh, tuple(axes))
    return all_reduce(t, mesh, axes)


def gather_partial(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """:func:`gather_sum` of rank-partial blocks into a replicated
    ``[n, *t.shape]``; the gradient of this rank's block is its slice."""
    if _on_graph(t):
        return _GatherPartial.apply(t, mesh, tuple(axes))
    return gather_sum(t, mesh, axes)


def gather_to_partial(t: torch.Tensor, mesh,
                      axes: Sequence[str]) -> torch.Tensor:
    """:func:`gather_sum` of blocks whose replicated ``[n, *t.shape]``
    feeds rank-partial work (each rank computes with its own part of it):
    the gradient is summed over ``axes``, then this rank's slice is taken.
    Off the autograd graph :func:`gather_sum`."""
    if _on_graph(t):
        return _GatherToPartial.apply(t, mesh, tuple(axes))
    return gather_sum(t, mesh, axes)


def fsdp_gather(t: torch.Tensor, mesh, axes: Sequence[str],
                dim: int) -> torch.Tensor:
    """The whole leaf from every rank's FSDP slice of it on ``dim`` along
    ``axes`` (rank i holds slice i, first-axis-major); the gradient is
    reduce-scattered: summed over ``axes``, then this rank's slice."""
    return _FsdpGather.apply(t, mesh, tuple(axes), dim)


@torch.no_grad()
def mean(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The mean over ``axes`` of a detached copy of ``t``."""
    out = all_reduce(t.detach().clone(memory_format=torch.contiguous_format),
                     mesh, axes)
    return out / mesh.axes_size(axes)
