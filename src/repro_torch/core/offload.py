"""Offload execution engine (paper §III "task scheduler" actuation).

The primary keeps (1−r)·B of the batch, ships r·B to the auxiliary, both
execute, results merge.  A *node group* is a list of ``torch.device``s; the
engine runs over a :class:`~repro_torch.core.topology.Topology` (group 0 =
hub), and the 2-node constructor is a shim over ``Topology.pair``.

``run`` dispatches every group before awaiting any: each group's task is
enqueued on its own CUDA stream, and completion is polled through
``torch.cuda.Event.query()`` (the counterpart of JAX's ``is_ready()``), so
``OffloadReport.t_parallel`` is a measured makespan.  With ``jit=False``
(host-loop tasks, e.g. a ``generate()`` loop that syncs internally) the
groups run one after another, as in the JAX package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.network import LinkModel, offload_energy, offload_latency
from repro_torch.core.profiler import DeviceProfile


class GroupUnavailableError(RuntimeError):
    """A node group is unreachable (killed, partitioned, crashed): work
    dispatched to it fails fast with the group named."""

    def __init__(self, group: str, msg: str = ""):
        self.group = group
        super().__init__(msg or f"node group {group!r} is unavailable")


class GroupTimeoutError(GroupUnavailableError):
    """The group did not complete within ``group_timeout_s`` -- a wedged
    arm, distinct from an outright crash."""


@dataclass
class GroupHealth:
    """Chaos/health surface of a :class:`NodeGroup`.  ``check(kind)`` raises
    :class:`GroupUnavailableError` when the group is down or an armed
    one-shot fault fires on the (``after``+1)-th call of that kind;
    ``wedge()`` simulates a hung arm that only ``group_timeout_s`` ends."""
    alive: bool = True
    wedged: bool = False
    _fault: Optional[Tuple[str, int, bool]] = None
    _calls: Dict[str, int] = field(default_factory=dict)

    KINDS = ("dispatch", "await")

    def kill(self) -> None:
        self.alive = False

    def restore(self) -> None:
        self.alive = True
        self.wedged = False
        self._fault = None
        self._calls = {}

    def wedge(self) -> None:
        self.wedged = True

    def inject_fault(self, kind: str = "dispatch", *, after: int = 0,
                     timeout: bool = False) -> None:
        if kind not in self.KINDS:
            raise ValueError(f"kind must be one of {self.KINDS}")
        self._fault = (kind, int(after), bool(timeout))

    def check(self, kind: str, name: str = "group") -> None:
        """Raise if the group is down or an armed fault fires now."""
        if not self.alive:
            raise GroupUnavailableError(name, f"node group {name!r} is down")
        self._calls[kind] = self._calls.get(kind, 0) + 1
        if self._fault is not None and self._fault[0] == kind \
                and self._calls[kind] > self._fault[1]:
            _, _, timeout = self._fault
            self._fault = None            # one-shot: spent once fired
            self.alive = False
            err = GroupTimeoutError if timeout else GroupUnavailableError
            raise err(name, f"node group {name!r} "
                      f"{'timed out' if timeout else 'died'} on "
                      f"{kind} #{self._calls[kind]}")


def mesh_axis_sizes(n_devices: int, n_axes: int,
                    axis_sizes: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Factor ``n_devices`` into ``n_axes`` mesh-axis sizes, largest first.

    An explicit ``axis_sizes`` is validated against the device count;
    otherwise the factorization is balanced greedily -- each axis takes the
    smallest divisor of the remainder at or above the even split
    rem^(1/axes_left), which keeps the factors descending -- so 8 devices
    over 2 axes give (4, 2), 4 give (2, 2), 12 over 3 give (3, 2, 2) and
    a prime count degenerates to (n, 1, ...).
    """
    if axis_sizes is not None:
        sizes = tuple(int(s) for s in axis_sizes)
        if len(sizes) != n_axes:
            raise ValueError(f"axis_sizes {sizes} has {len(sizes)} entries "
                             f"for {n_axes} axes")
        prod = 1
        for s in sizes:
            prod *= s
        if prod != n_devices:
            raise ValueError(f"axis_sizes {sizes} does not cover "
                             f"{n_devices} devices")
        return sizes
    sizes = []
    rem = n_devices
    for axes_left in range(n_axes, 1, -1):
        # smallest divisor of rem at or above the even split rem^(1/axes):
        # keeps factors descending, e.g. 12 over 3 axes -> (3, 2, 2)
        target = rem ** (1.0 / axes_left)
        d = rem
        for cand in range(1, rem + 1):
            if rem % cand == 0 and cand >= target - 1e-9:
                d = cand
                break
        sizes.append(d)
        rem //= d
    sizes.append(rem)
    return tuple(sizes)


@dataclass
class NodeGroup:
    """A node group: its devices, and (under ``torch.distributed``) the
    ranks that serve it as one SPMD program (None: every rank of the
    process group, or this process alone without one)."""
    name: str
    devices: List[torch.device]
    profile: DeviceProfile
    health: GroupHealth = field(default_factory=GroupHealth)
    ranks: Optional[List[int]] = None

    def mesh(self, axes=("data",), axis_sizes: Optional[Sequence[int]] = None):
        """The port's :class:`~repro_torch.launch.mesh.Mesh` over the
        group's ranks, factored over ``axes`` by :func:`mesh_axis_sizes`
        (a collective when a process group is initialised: every rank
        calls it)."""
        from repro_torch.launch.mesh import Mesh, world_ranks
        ranks = np.array(world_ranks() if self.ranks is None else self.ranks)
        if len(axes) == 1:
            return Mesh(ranks, axes)
        shape = mesh_axis_sizes(len(ranks), len(axes), axis_sizes)
        return Mesh(ranks.reshape(shape), axes)

    @property
    def alive(self) -> bool:
        return self.health.alive

    def kill(self) -> None:
        self.health.kill()

    def restore(self) -> None:
        self.health.restore()

    def inject_fault(self, kind: str = "dispatch", *, after: int = 0,
                     timeout: bool = False) -> None:
        self.health.inject_fault(kind, after=after, timeout=timeout)


@dataclass
class OffloadReport:
    r: float                    # total offloaded fraction (1 − hub share)
    n_local: int
    n_offloaded: int
    t_local_s: float            # hub completion since joint dispatch
    t_remote_s: float           # slowest spoke completion since joint dispatch
    t_offload_s: float          # slowest spoke link latency (model-predicted)
    payload_bytes: float
    e_offload_j: float
    outputs: Any = None
    t_parallel_s: float = 0.0   # measured makespan of the overlapped dispatch
                                # (0.0 when the task could not overlap, e.g.
                                # host-loop jit=False tasks)
    group_names: Tuple[str, ...] = ()
    n_group: Tuple[int, ...] = ()
    t_group_s: Tuple[float, ...] = ()   # per-group completion since dispatch
    t_link_s: Tuple[float, ...] = ()    # per-edge link latency (hub entry 0.0)
    host_syncs: int = 0         # device->host reads: one await per
                                # dispatched group here; the serving
                                # engines report one per macro-step + one
                                # per admission phase
    # --- continuous serving (filled by HeteroRuntime.serve per wave) -------
    admission_stalls: int = 0   # macro boundaries where live decode slots
                                # waited on a prefill
    t_prefill_overlap_s: float = 0.0  # shadow-prefill dispatch wall hidden
                                      # behind in-flight decode macro-steps
    prefill_offloaded: int = 0  # shadow prefills sent to the prefill group
    t_kv_transfer_s: float = 0.0  # priced KV-transfer hop total
    prefill_fallbacks: int = 0  # prefill-group failures recovered by local
                                # shadow prefill (streams unchanged)
    prefix_hits: int = 0        # admissions that matched the radix trie
    prefix_blocks_reused: int = 0  # trie blocks spliced into resumed
                                   # prefills instead of recomputed
    prefill_flops_avoided: float = 0.0  # analytic prefill FLOPs skipped
    prefill_flops_total: float = 0.0    # ...of this analytic total
    kv_hop_bytes_raw: float = 0.0   # uncompacted block bytes of the hops
    kv_hop_bytes_wire: float = 0.0  # bytes that crossed (compacted tails)
    group_alive: Tuple[bool, ...] = ()  # liveness per decode group this
                                        # wave (ordered like group_names)
    wave_requeued: int = 0      # requests re-queued onto survivors after a
                                # mid-wave group failure
    wave_retries: int = 0       # re-queued requests completing this wave
    link_bw_hz: Tuple[float, ...] = ()  # live traced rate per decode edge
                                        # (hub entry 0.0)
    mobility_latched: int = 0   # edges forced local this wave by the
                                # β-threshold mobility latch (§V-A.5)
    admission_hot: Tuple[bool, ...] = ()   # per-decode-group hot flag
    admission_rerouted: int = 0  # requests the hot mask re-routed this wave
    power_headroom_w: Tuple[float, ...] = ()   # P_available − threshold
    mem_headroom_frac: Tuple[float, ...] = ()  # λ − kv_bytes/(chips·memory)
    t_splice_s: float = 0.0     # wall of the fused cross-group splices
    t_slot_write_s: float = 0.0  # wall of the per-slot cache writes
    t_dispatch_s: float = 0.0   # wall submitting decode macro-steps
    t_await_s: float = 0.0      # wall blocked on the token blocks

    @property
    def t_parallel(self) -> float:
        """Completion time with full overlap: measured when every group was
        dispatched before any was awaited, else derived from the serial
        per-group timings."""
        if self.t_group_s:
            derived = max(tl + tg for tl, tg
                          in zip(self.t_link_s, self.t_group_s))
        else:
            derived = max(self.t_local_s, self.t_offload_s + self.t_remote_s)
        if self.t_parallel_s > 0.0:
            return max(self.t_parallel_s, self.t_offload_s + self.t_remote_s)
        return derived

    @property
    def t_serial(self) -> float:
        """Paper-objective-style serial accounting: r(T1+T3) + (1-r)T2,
        generalized to Σ_g (T_g + link_g)."""
        if self.t_group_s:
            return sum(self.t_group_s) + sum(self.t_link_s)
        return self.t_local_s + self.t_remote_s + self.t_offload_s


def split_sizes(batch: int, r: float) -> Tuple[int, int]:
    """(n_offloaded, n_local); n_offloaded = round(r·B) like the paper's
    70 / 30 image split."""
    n_off = int(round(r * batch))
    return n_off, batch - n_off


def _as_fractions(split, n_groups: int) -> Tuple[float, ...]:
    """Normalize a split spec -- scalar r, or a sequence / object with
    ``fractions`` -- into per-group fractions ordered hub first."""
    if hasattr(split, "fractions"):
        fr = tuple(float(f) for f in split.fractions)
    elif isinstance(split, (int, float)):
        if n_groups != 2:
            raise ValueError(
                f"scalar split ratio is only defined for 2 groups; this "
                f"topology has {n_groups}")
        fr = (1.0 - float(split), float(split))
    else:
        fr = tuple(max(0.0, float(f)) for f in split)
        s = sum(fr)
        if s <= 0.0:
            raise ValueError(f"split fractions {fr} sum to zero")
        fr = tuple(f / s for f in fr)
    if len(fr) != n_groups:
        raise ValueError(f"split has {len(fr)} fractions for "
                         f"{n_groups} groups")
    return fr


def split_counts(fractions: Sequence[float], batch: int) -> Tuple[int, ...]:
    """Apportion ``batch`` items over the fractions (hub first): the pair
    defers to :func:`split_sizes`, N groups use largest remainders."""
    if len(fractions) == 2:
        n_off, n_loc = split_sizes(batch, fractions[1])
        return (n_loc, n_off)
    quotas = [f * batch for f in fractions]
    counts = [int(q) for q in quotas]
    rem = batch - sum(counts)
    order = sorted(range(len(quotas)),
                   key=lambda g: (quotas[g] - counts[g], -g), reverse=True)
    for g in order[:rem]:
        counts[g] += 1
    return tuple(counts)


# --- trees of tensors / arrays (dicts, lists, tuples) -------------------------
def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _concat_on(device: torch.device):
    def concat(*xs):
        if torch.is_tensor(xs[0]):
            return torch.cat([x.to(device) for x in xs], dim=0)
        return np.concatenate(xs, axis=0)
    return concat


def _block_until_ready(tree) -> None:
    devs = {x.device for x in tree_leaves(tree)
            if torch.is_tensor(x) and x.is_cuda}
    for dev in devs:
        torch.cuda.synchronize(dev)


class OffloadEngine:
    """Executes one workload batch split across the node groups of a
    topology (group 0 = hub/primary, groups 1.. = spokes/auxiliaries).
    ``OffloadEngine(task_fn, primary, auxiliary, link, ...)`` is the 2-node
    shim over ``Topology.pair``."""

    def __init__(self, task_fn: Callable[[Any], Any],
                 primary: Optional[NodeGroup] = None,
                 auxiliary: Optional[NodeGroup] = None,
                 link: Optional[LinkModel] = None, *,
                 topology: Optional[Any] = None,
                 payload_bytes_per_item: float,
                 distance_fn: Callable[[], float] = lambda: 1.0,
                 jit: bool = True,
                 group_timeout_s: Optional[float] = None):
        if topology is None:
            if primary is None or auxiliary is None or link is None:
                raise ValueError("pass either topology= or the 2-node "
                                 "(primary, auxiliary, link) triple")
            from repro_torch.core.topology import Topology
            topology = Topology.pair(primary, auxiliary, link)
        self.task_fn = task_fn
        self.topology = topology
        self.payload_bytes_per_item = payload_bytes_per_item
        self.distance_fn = distance_fn
        # True: task_fn only enqueues device work, so every group is in
        # flight before any is awaited; False: host-loop tasks, run serially
        self.jit = jit
        if group_timeout_s is not None and group_timeout_s <= 0.0:
            raise ValueError(f"group_timeout_s must be > 0, "
                             f"got {group_timeout_s}")
        self.group_timeout_s = group_timeout_s
        self._streams: Dict[str, torch.cuda.Stream] = {}

    # --- 2-node legacy accessors ------------------------------------------
    @property
    def primary(self) -> NodeGroup:
        return self.topology.groups[0]

    @property
    def auxiliary(self) -> NodeGroup:
        return self.topology.groups[1]

    @property
    def link(self) -> LinkModel:
        return self.topology.links[1]

    @staticmethod
    def _slice_batch(batch, lo, hi):
        return tree_map(lambda a: a[lo:hi], batch)

    def _stream(self, group: NodeGroup) -> Optional[torch.cuda.Stream]:
        """The group's own CUDA stream (None for a CPU group)."""
        dev = torch.device(group.devices[0])
        if dev.type != "cuda":
            return None
        if group.name not in self._streams:
            self._streams[group.name] = torch.cuda.Stream(device=dev)
        return self._streams[group.name]

    def _dispatch(self, group: NodeGroup, sl):
        """Enqueue the task on the group's stream; returns (out, event)."""
        stream = self._stream(group)
        if stream is None:
            return self.task_fn(sl), None
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            out = self.task_fn(sl)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _await_groups(self, events: Dict[str, Optional[torch.cuda.Event]],
                      t0: float, healths: Dict[str, GroupHealth]
                      ) -> Dict[str, float]:
        """Poll every in-flight group, stamping each one's completion time
        relative to the joint dispatch without serializing on the others.
        A wedged group is never ready, so ``group_timeout_s`` surfaces it
        as :class:`GroupTimeoutError` (with no timeout it raises at once)."""
        for name in events:
            h = healths[name]
            h.check("await", name)
            if h.wedged and self.group_timeout_s is None:
                h.kill()
                raise GroupUnavailableError(
                    name, f"node group {name!r} is wedged and no "
                    "group_timeout_s is configured — refusing to hang")
        pending = dict(events)
        done: Dict[str, float] = {}
        while pending:
            for name in list(pending):
                if healths[name].wedged:
                    continue   # simulated hang: only the timeout ends it
                ev = pending[name]
                if ev is None or ev.query():
                    done[name] = time.perf_counter() - t0
                    del pending[name]
            if pending:
                if self.group_timeout_s is not None and \
                        time.perf_counter() - t0 > self.group_timeout_s:
                    for name in pending:
                        healths[name].kill()
                    raise GroupTimeoutError(
                        next(iter(pending)),
                        f"groups {sorted(pending)} still pending after "
                        f"{self.group_timeout_s}s await timeout")
                time.sleep(1e-4)
        return done

    def run(self, batch, split=None, *, r: Optional[float] = None
            ) -> OffloadReport:
        """Dispatch every node group, await after.

        ``split`` is a scalar r for the 2-node shim or a fraction sequence
        (hub first); ``r=`` is the 2-node keyword spelling.  Spokes take
        their slices from the front of the batch (in topology order), the
        hub keeps the tail -- so outputs merge back in batch order."""
        if (split is None) == (r is None):
            raise TypeError("pass exactly one of split or r=")
        if split is None:
            split = float(r)
        groups = self.topology.groups
        links = self.topology.links
        G = len(groups)
        fracs = _as_fractions(split, G)
        B = tree_leaves(batch)[0].shape[0]
        counts = split_counts(fracs, B)
        d = float(self.distance_fn())

        bounds: List[Tuple[int, int]] = [None] * G
        lo = 0
        for g in range(1, G):
            bounds[g] = (lo, lo + counts[g])
            lo += counts[g]
        bounds[0] = (lo, B)

        t_link = [0.0] * G
        e_link = [0.0] * G
        for g in range(1, G):
            if counts[g]:
                payload = counts[g] * self.payload_bytes_per_item
                t_link[g] = offload_latency(links[g], payload, d)
                e_link[g] = offload_energy(links[g], payload, d)

        out: List[Any] = [None] * G
        t_group = [0.0] * G
        t_par = 0.0
        t0 = time.perf_counter()
        if self.jit:
            # dispatch phase: launch ALL groups (spokes first), await NONE
            events: Dict[str, Optional[torch.cuda.Event]] = {}
            for g in list(range(1, G)) + [0]:
                if counts[g]:
                    groups[g].health.check("dispatch", groups[g].name)
                    sl = self._slice_batch(batch, *bounds[g])
                    out[g], events[groups[g].name] = self._dispatch(groups[g], sl)
            done = self._await_groups(
                events, t0, {groups[g].name: groups[g].health
                             for g in range(G) if counts[g]})
            t_group = [done.get(groups[g].name, 0.0) for g in range(G)]
            t_par = time.perf_counter() - t0
            # the merge below runs on the current stream
            for g in range(G):
                stream = self._stream(groups[g]) if counts[g] else None
                if stream is not None:
                    torch.cuda.current_stream(stream.device).wait_stream(stream)
        else:
            for g in [0] + list(range(1, G)):  # hub first
                if counts[g]:
                    groups[g].health.check("dispatch", groups[g].name)
                    t1 = time.perf_counter()
                    out[g] = self.task_fn(self._slice_batch(batch, *bounds[g]))
                    _block_until_ready(out[g])
                    t_group[g] = time.perf_counter() - t1

        # merge in slice order (spokes ascending, hub last) = batch order,
        # collected onto the hub's device
        parts = [out[g] for g in list(range(1, G)) + [0] if out[g] is not None]
        merged = None
        if parts:
            hub = torch.device(groups[0].devices[0])
            merged = tree_map(_concat_on(hub), *parts) \
                if len(parts) > 1 else parts[0]
        return OffloadReport(
            r=1.0 - fracs[0], n_local=counts[0],
            n_offloaded=B - counts[0],
            t_local_s=t_group[0], t_remote_s=max(t_group[1:], default=0.0),
            t_offload_s=max(t_link[1:], default=0.0),
            payload_bytes=sum(counts[g] * self.payload_bytes_per_item
                              for g in range(1, G) if counts[g]),
            e_offload_j=sum(e_link), outputs=merged, t_parallel_s=t_par,
            group_names=tuple(g.name for g in groups),
            n_group=tuple(counts), t_group_s=tuple(t_group),
            t_link_s=tuple(t_link),
            host_syncs=sum(1 for g in range(G) if counts[g]))


# ---------------------------------------------------------------------------
def padded_quota_batch(batch, r: float, n_groups: int = 2):
    """Re-lay a batch (a tree of tensors) as [n_groups, quota_max, ...] +
    validity mask for the single-program multi-pod step.  Group 0 =
    auxiliary (gets round(r·B)), group 1 = primary."""
    B = tree_leaves(batch)[0].shape[0]
    n_off, n_loc = split_sizes(B, r)
    quota = max(n_off, n_loc, 1)

    def relay(a):
        pad = torch.zeros((n_groups * quota - B, *a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        aux = torch.cat([a[:n_off], pad[:quota - n_off]], 0)
        loc = torch.cat([a[n_off:], pad[:quota - n_loc]], 0)
        return torch.stack([aux, loc])

    ar = torch.arange(quota)
    mask = torch.stack([ar < n_off, ar < n_loc])
    return tree_map(relay, batch), mask
