"""Disaggregated prefill: a client for the dedicated prefill node group.

The JAX package's ``repro/serving/prefill.py`` on PyTorch.  A
``PrefillWorker`` runs the continuous engine's shadow prefills on the
prefill group's device instead of the decode group's; the finished KV block
comes back at the macro boundary over the priced link (``t_kv_transfer_s``)
and the engine splices it into a freed slot.  A resumed prefill ships only
its tail, compacted by ``masked_compact`` (``prefix_cache.compact_kv_hop``).

Inside ``models.sharding.activation_sharding(mesh)`` a worker runs
mesh-wide like every other program, as the JAX package's does: each rank's
worker prefills on that rank's device with its slice of the params, and a
block's KV hop carries (and compacts) that rank's own rows, which the rank
splices locally.

Failure semantics: ``dispatch`` / ``fetch`` raise :class:`PrefillWorkerError`
(or its :class:`PrefillWorkerTimeout` subclass) once the worker is
``kill()``ed or an injected fault fires, and the engine falls back to local
shadow prefill for that request and every later one, with the same token
streams; ``inject_fault`` is the chaos-test hook.
"""
from __future__ import annotations

import hashlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import is_mla
from repro_torch.core.network import offload_latency
from repro_torch.core.offload import tree_leaves, tree_map
from repro_torch.device import DeviceLike, resolve_device, upload
from repro_torch.kernels.ops import resolve_use_kernels
from repro_torch.models.sharding import active_mesh
from repro_torch.serving.engine import make_prefill_step
from repro_torch.serving.prefix_cache import compact_kv_hop, restore_kv_hop


class PrefillWorkerError(RuntimeError):
    """The prefill group is unreachable (killed, crashed, partitioned)."""


class PrefillWorkerTimeout(PrefillWorkerError):
    """The prefill group did not answer within its deadline."""


def _tree_bytes(tree: Any) -> float:
    """Total payload bytes of a tree of tensors (the KV-transfer size)."""
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                     if torch.is_tensor(t)))


class PrefillWorker:
    """One task's prefill client for the dedicated prefill group.

    ``dispatch(batch)`` runs the B=1 prefill on the worker's device and
    returns ``(logits, cache)``; ``fetch`` brings a finished block to the
    decode group's device and returns the priced KV-transfer latency.  On
    the engine's own device the worker aliases the engine's params (no
    copy: nemotron-4-15b's 31 GB could not be held twice); on another
    device it holds one copy.  Runs on the card unless ``device`` says
    otherwise.

    ``healthy`` goes False on ``kill()`` or when an injected fault fires;
    every later call raises, and the engine stops routing prefills here."""

    def __init__(self, cfg, params, *, device: DeviceLike = None, link=None,
                 distance: float = 1.0, name: str = "prefill",
                 use_kernels="auto", kv_keep_rate: Optional[float] = None,
                 share_from: Optional["PrefillWorker"] = None):
        """``kv_keep_rate``: the lossy hop knob -- keep only this fraction
        of a resumed transfer's tail rows (None = lossless, the default).
        ``share_from``: another worker over the same cfg and device whose
        params and prefill function this one reuses (the pool idiom)."""
        if is_mla(cfg):
            raise ValueError(f"{cfg.name}: the KV hop does not carry a "
                             "latent cache (multi-head latent attention "
                             "prefills on its own group)")
        self.cfg = cfg
        self.name = name
        self.link = link
        self.distance = float(distance)
        self.kv_keep_rate = kv_keep_rate
        if active_mesh() is not None:
            # mesh-wide: the prefill group is an accounting entity, and each
            # rank prefills where its slice of the params lives
            device = tree_leaves(params)[0].device
        self.device = resolve_device(device)
        if share_from is not None:
            self.params = share_from.params
            self._prefill = share_from._prefill
        else:
            # Tensor.to returns the tensor itself when it is already there
            self.params = tree_map(lambda t: t.to(self.device), params)
            self._prefill = make_prefill_step(
                cfg, use_kernels=resolve_use_kernels(use_kernels, self.device))
        self.healthy = True
        self._fault: Optional[Tuple[str, int, type]] = None
        self._calls = {"dispatch": 0, "fetch": 0}
        self._payload_cache: dict = {}   # (logits, cache) shapes -> bytes
        self.dispatched = 0
        self.transferred_bytes = 0.0
        # raw and on-the-wire bytes of every fetch; ``last_fetch_bytes`` is
        # the (raw, wire) pair of the latest one
        self.kv_bytes_raw = 0.0
        self.kv_bytes_wire = 0.0
        self.last_fetch_bytes: Tuple[float, float] = (0.0, 0.0)

    # -- chaos hooks ----------------------------------------------------
    def kill(self) -> None:
        """Simulate losing the prefill group (node crash / partition)."""
        self.healthy = False

    def restore(self) -> None:
        """Simulate the prefill group coming back: clears any armed fault
        and the call counters."""
        self.healthy = True
        self._fault = None
        self._calls = {"dispatch": 0, "fetch": 0}

    def inject_fault(self, kind: str = "dispatch", *, after: int = 0,
                     timeout: bool = False) -> None:
        """Arm a one-shot fault: the (``after``+1)-th ``kind`` call kills
        the worker and raises (``PrefillWorkerTimeout`` when ``timeout``)."""
        if kind not in self._calls:
            raise ValueError(f"kind must be one of {sorted(self._calls)}")
        err = PrefillWorkerTimeout if timeout else PrefillWorkerError
        self._fault = (kind, int(after), err)

    def set_link(self, link, distance: Optional[float] = None) -> None:
        """Price future KV hops on ``link`` (and ``distance``)."""
        self.link = link
        if distance is not None:
            self.distance = float(distance)

    def _check(self, kind: str) -> None:
        if not self.healthy:
            raise PrefillWorkerError(f"prefill group {self.name!r} is down")
        self._calls[kind] += 1
        if self._fault is not None and self._fault[0] == kind \
                and self._calls[kind] > self._fault[1]:
            err = self._fault[2]
            self.healthy = False
            raise err(f"prefill group {self.name!r} "
                      f"{'timed out' if err is PrefillWorkerTimeout else 'died'}"
                      f" on {kind} #{self._calls[kind]}")

    # -- hot path -------------------------------------------------------
    def dispatch(self, batch) -> Tuple[Any, Any]:
        """Run one B=1 prefill on the prefill group: ``batch["tokens"]`` and
        ``batch["frontend"]`` (vlm/audio) are host-side (numpy),
        ``batch["prefix"]`` (optional) a cached KV tree.  On the card the
        work is queued on the current stream."""
        self._check("dispatch")
        dev_batch = {k: upload(np.asarray(batch[k]), self.device)
                     for k in ("tokens", "frontend") if k in batch}
        if "prefix" in batch:
            dev_batch["prefix"] = tree_map(lambda t: t.to(self.device),
                                           batch["prefix"])
        with torch.no_grad():
            out = self._prefill(self.params, dev_batch)
        self.dispatched += 1
        return out

    def fetch(self, logits, cache=None, *, target: DeviceLike = None,
              prefix=None):
        """Bring a finished block to the decode group.

        Returns ``(logits, cache, t_kv_transfer_s)`` on ``target`` (the
        decode group's device; None = the worker's own) with the hop priced
        by the link over the bytes that cross it.  Raises if the group died
        in flight.  When ``prefix`` is a prefix-cache hit's KV tree (rows
        ``[0, q)`` already held decode-side), only the tail rows cross,
        compacted by the sender (``compact_kv_hop``); the full-length cache
        is rebuilt here from the prefix and the hop.  ``last_fetch_bytes``
        records the (raw, wire) pair."""
        self._check("fetch")
        key = (tuple(logits.shape),
               None if cache is None else tuple(tree_leaves(cache)[0].shape))
        raw = self._payload_cache.get(key)
        if raw is None:
            raw = _tree_bytes(logits) + (_tree_bytes(cache)
                                         if cache is not None else 0.0)
            self._payload_cache[key] = raw
        wire = raw
        packed = None
        if prefix is not None and cache is not None:
            q_rows = int(tree_leaves(prefix)[0].shape[2])
            total = int(tree_leaves(cache)[0].shape[2])
            if 0 < q_rows < total:   # q == S would pack no row: ship raw
                packed, wire_kv = compact_kv_hop(
                    cache, q_rows, keep_rate=self.kv_keep_rate)
                wire = _tree_bytes(logits) + wire_kv
        tgt = self.device if target is None else torch.device(target)
        if tgt != self.device:
            # a cross-device move: with a packed hop only the compacted
            # rows and their indices cross
            logits = logits.to(tgt)
            if packed is not None:
                packed = {name: ((val[0].to(tgt), val[1].to(tgt), val[2])
                                 if isinstance(val, tuple) else val)
                          for name, val in packed.items()}
            elif cache is not None:
                cache = tree_map(lambda t: t.to(tgt), cache)
        if packed is not None:
            cache = restore_kv_hop(packed, prefix)
        self.transferred_bytes += wire
        self.kv_bytes_raw += raw
        self.kv_bytes_wire += wire
        self.last_fetch_bytes = (raw, wire)
        t_hop = 0.0
        if self.link is not None:
            t_hop = float(offload_latency(self.link, wire, self.distance))
        return logits, cache, t_hop


class PrefillWorkerPool:
    """N prefill workers behind one worker-shaped facade.

    Dispatch is keyed by a content hash of the prompt tokens: the same
    prompt lands on the same member first, failing over in ring order past
    unhealthy or failing members.  ``fetch`` routes each block back to the
    member that produced it.  Members share the first worker's params and
    prefill function.  ``kill``/``restore`` broadcast, ``inject_fault(...,
    worker=i)`` arms one member, and the pool is ``healthy`` while any
    member is."""

    def __init__(self, cfg, params, *, size: int, device: DeviceLike = None,
                 link=None, distance: float = 1.0, name: str = "prefill",
                 use_kernels="auto", kv_keep_rate: Optional[float] = None):
        if size < 1:
            raise ValueError(f"pool size must be >= 1, got {size}")
        self.cfg = cfg
        self.name = name
        self.link = link
        self.distance = float(distance)
        self.kv_keep_rate = kv_keep_rate
        self.workers = []
        for i in range(size):
            self.workers.append(PrefillWorker(
                cfg, params, device=device, link=link, distance=distance,
                name=f"{name}[{i}]", use_kernels=use_kernels,
                kv_keep_rate=kv_keep_rate,
                share_from=self.workers[0] if self.workers else None))
        # id(logits) -> member; the engine holds the logits from dispatch
        # to fetch, so the id cannot be recycled while the entry exists
        self._inflight: dict = {}
        self.last_fetch_bytes: Tuple[float, float] = (0.0, 0.0)

    # -- affinity -------------------------------------------------------
    @staticmethod
    def _batch_key(batch) -> int:
        """Stable content hash of the prompt tokens (host-side: no device
        read on the dispatch path)."""
        toks = np.asarray(batch["tokens"])
        digest = hashlib.blake2b(toks.tobytes(), digest_size=8).digest()
        return int.from_bytes(digest, "big")

    # -- chaos hooks ----------------------------------------------------
    @property
    def healthy(self) -> bool:
        return any(w.healthy for w in self.workers)

    def kill(self) -> None:
        for w in self.workers:
            w.kill()

    def restore(self) -> None:
        # in-flight entries survive: a block dispatched before the kill
        # still fetches from (and raises on) the member that owned it
        for w in self.workers:
            w.restore()

    def inject_fault(self, kind: str = "dispatch", *, after: int = 0,
                     timeout: bool = False, worker: int = 0) -> None:
        """Arm a one-shot fault on one member (default the first)."""
        self.workers[worker].inject_fault(kind, after=after, timeout=timeout)

    def set_link(self, link, distance: Optional[float] = None) -> None:
        """Broadcast a live-link update to every member."""
        self.link = link
        if distance is not None:
            self.distance = float(distance)
        for w in self.workers:
            w.set_link(link, distance)

    # -- hot path -------------------------------------------------------
    def dispatch(self, batch) -> Tuple[Any, Any]:
        """Launch on the affinity member, failing over in ring order;
        raises :class:`PrefillWorkerError` only when every member is
        unusable."""
        n = len(self.workers)
        start = self._batch_key(batch) % n
        last_err: Optional[PrefillWorkerError] = None
        for off in range(n):
            w = self.workers[(start + off) % n]
            if not w.healthy:
                continue
            try:
                logits, cache = w.dispatch(batch)
            except PrefillWorkerError as e:   # fault fired mid-dispatch
                last_err = e
                continue
            self._inflight[id(logits)] = w
            return logits, cache
        raise last_err if last_err is not None else PrefillWorkerError(
            f"prefill pool {self.name!r}: no healthy workers")

    def fetch(self, logits, cache=None, *, target: DeviceLike = None,
              prefix=None):
        """Fetch from the member that dispatched this block."""
        w = self._inflight.pop(id(logits), None)
        if w is None:
            raise PrefillWorkerError(
                f"prefill pool {self.name!r}: unknown in-flight block")
        out = w.fetch(logits, cache, target=target, prefix=prefix)
        self.last_fetch_bytes = w.last_fetch_bytes
        return out

    # -- aggregate accounting ------------------------------------------
    @property
    def dispatched(self) -> int:
        return sum(w.dispatched for w in self.workers)

    @property
    def transferred_bytes(self) -> float:
        return sum(w.transferred_bytes for w in self.workers)

    @property
    def kv_bytes_raw(self) -> float:
        return sum(w.kv_bytes_raw for w in self.workers)

    @property
    def kv_bytes_wire(self) -> float:
        return sum(w.kv_bytes_wire for w in self.workers)
