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
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Sequence

import torch
import torch.distributed as dist

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

    def add(self, kind: str, t: torch.Tensor) -> None:
        self.bytes[kind] += float(t.numel() * t.element_size())
        self.calls[kind] += 1

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


def _issue(kind: str, t: torch.Tensor, mesh, axes: Sequence[str]):
    group = mesh.group(axes)
    if group is None or mesh.axes_size(mesh.canon(axes)) == 1:
        return None
    for counter in mesh.counters:
        counter.add(kind, t)
    return group


def _spent(mesh, t0: float) -> None:
    dt = time.perf_counter() - t0
    for counter in mesh.counters:
        counter.seconds += dt


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over the ranks that share every coordinate of
    this rank but those on ``axes``; returns ``t``."""
    group = _issue("all-reduce", t, mesh, axes)
    if group is not None:
        t0 = time.perf_counter()
        dist.all_reduce(t, op=_OPS[op], group=group)
        _spent(mesh, t0)
    return t


def broadcast(t: torch.Tensor, mesh, axes: Sequence[str] = ()) -> torch.Tensor:
    """Overwrite ``t`` in place with its value on the first rank of this
    rank's line along ``axes`` (default: the whole mesh); returns ``t``."""
    axes = tuple(axes) or mesh.axes
    group = _issue("broadcast", t, mesh, axes)
    if group is not None:
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
