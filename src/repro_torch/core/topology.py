"""N-node topology + multi-task serving session (paper §VIII future work).

The paper hard-wires one primary/auxiliary pair; its §VIII names
star-topology multi-node offloading as the extension.  This module is that
generalization:

* :class:`Topology` — an ordered list of
  :class:`~repro_torch.core.offload.NodeGroup`s plus per-edge
  :class:`~repro_torch.core.network.LinkModel`s.  Group 0 is the hub (the
  paper's "primary": work stays local there, no link cost); groups 1.. are
  spokes.  ``Topology.pair`` is the paper's 2-node testbed,
  ``Topology.star`` the §VIII extension.
* :class:`SplitVector` — per-group fractions on the simplex.  Reduces to
  the paper's scalar r for the 2-node case (r = offloaded share).
* :class:`HeteroRuntime` — one session object composing the solver, the
  online controller and continuous serving: a multi-task registry
  (``add_task``) of per-group continuous-batching engines, and
  ``serve(requests)`` draining waves over the groups while the controller
  re-solves the split (Eq. 4 for 2 groups, ``solve_star`` beyond) from
  measured per-group timings.  ``serve`` returns a :class:`ServeResult`
  with structured telemetry.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.admission import (AdmissionController, GroupBudget,
                                        kv_cache_bytes)
from repro_torch.core.mobility import LinkTrace
from repro_torch.core.network import LinkModel, data_rate, offload_latency
from repro_torch.core.offload import (GroupUnavailableError, NodeGroup,
                                      OffloadReport, split_counts, tree_map)
from repro_torch.core.scheduler import (Backoff, ControllerConfig,
                                        PrefillRouter, SplitRatioController)
# the engine module imports this package's offload helpers: bind it as a
# module so either side can be imported first
from repro_torch.serving import engine as _engine

if TYPE_CHECKING:
    from repro_torch.serving.engine import (ContinuousServingEngine,
                                            RequestOutput, ServeRequest)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SplitVector:
    """Per-group work fractions on the simplex, ordered like the topology
    (hub first).  The paper's scalar split ratio is the 2-group special
    case: r = 1 − f_hub."""
    fractions: Tuple[float, ...]

    def __post_init__(self):
        fr = tuple(max(0.0, float(f)) for f in self.fractions)
        s = sum(fr)
        if s <= 0.0:
            fr = (1.0,) + (0.0,) * (len(fr) - 1)  # degenerate: all local
        else:
            fr = tuple(f / s for f in fr)
        object.__setattr__(self, "fractions", fr)

    @staticmethod
    def from_r(r: float, n_groups: int = 2) -> "SplitVector":
        """Scalar split ratio → vector: hub keeps 1−r, spokes share r
        equally (exactly the paper's pair when n_groups == 2)."""
        r = float(np.clip(r, 0.0, 1.0))
        spokes = max(n_groups - 1, 1)
        return SplitVector((1.0 - r,) + (r / spokes,) * (n_groups - 1))

    @property
    def r(self) -> float:
        """Total offloaded share (1 − hub fraction); the paper's r."""
        return 1.0 - self.fractions[0]

    def masked(self, alive: Sequence[bool]) -> "SplitVector":
        """Re-project onto the surviving simplex: dead groups drop to
        exactly 0, survivors renormalize (even split over survivors when
        every surviving fraction was 0).  Raises when the mask kills
        every group — there is nowhere left to send the wave."""
        alive = tuple(bool(a) for a in alive)
        if len(alive) != len(self.fractions):
            raise ValueError(f"alive mask has {len(alive)} entries for "
                             f"{len(self.fractions)} groups")
        if not any(alive):
            raise GroupUnavailableError(
                "all", "every group is masked dead — nothing can take "
                "the wave")
        fr = [f if a else 0.0 for f, a in zip(self.fractions, alive)]
        if sum(fr) <= 0.0:
            n_live = sum(alive)
            fr = [1.0 / n_live if a else 0.0 for a in alive]
        return SplitVector(tuple(fr))

    def __len__(self) -> int:
        return len(self.fractions)

    def counts(self, batch: int) -> Tuple[int, ...]:
        """Apportion ``batch`` items per group; the pair case is
        bit-identical to ``split_sizes`` (see offload.split_counts)."""
        return split_counts(self.fractions, batch)


# ---------------------------------------------------------------------------
@dataclass
class Topology:
    """Ordered node groups + per-edge links.  ``links[0]`` is None — the
    hub's work never crosses a link; ``links[g]`` prices hub→group-g.

    ``prefill_spoke`` marks one spoke as a *dedicated prefill
    group*: it takes no decode waves — the serving runtime disaggregates
    shadow prefills onto it and splices the resulting KV blocks back into
    the decode groups' slots, pricing the KV-transfer hop with that
    spoke's LinkModel."""
    groups: List[NodeGroup]
    links: List[Optional[LinkModel]]
    kind: str = "pair"
    prefill_spoke: Optional[int] = None   # group index of the prefill group

    def __post_init__(self):
        if len(self.groups) < 2:
            raise ValueError("a topology needs at least hub + one spoke")
        if len(self.links) != len(self.groups):
            raise ValueError("need one link entry per group (hub's is None)")
        if any(l is None for l in self.links[1:]):
            raise ValueError("every spoke needs a LinkModel")
        names = [g.name for g in self.groups]
        if len(set(names)) != len(names):
            # group name keys the engine's await map, the task registry's
            # per-group engines and the telemetry — duplicates silently
            # drop groups from all three
            raise ValueError(f"group names must be unique, got {names}")
        if self.prefill_spoke is not None:
            ps = int(self.prefill_spoke)
            if not 1 <= ps < len(self.groups):
                raise ValueError(
                    f"prefill_spoke must name a spoke (1..{len(self.groups) - 1}),"
                    f" got {self.prefill_spoke} — the hub always decodes")
            self.prefill_spoke = ps

    def __len__(self) -> int:
        return len(self.groups)

    @property
    def hub(self) -> NodeGroup:
        return self.groups[0]

    @property
    def spokes(self) -> List[NodeGroup]:
        return self.groups[1:]

    @property
    def prefill_group(self) -> Optional[NodeGroup]:
        """The dedicated prefill group, or None (local shadow prefill)."""
        if self.prefill_spoke is None:
            return None
        return self.groups[self.prefill_spoke]

    @property
    def prefill_link(self) -> Optional[LinkModel]:
        """LinkModel pricing the KV-transfer hop back from the prefill group."""
        if self.prefill_spoke is None:
            return None
        return self.links[self.prefill_spoke]

    def decode_indices(self) -> List[int]:
        """Group indices that take decode waves (everything but the
        dedicated prefill spoke)."""
        return [g for g in range(len(self.groups)) if g != self.prefill_spoke]

    @staticmethod
    def pair(primary: NodeGroup, auxiliary: NodeGroup,
             link: LinkModel) -> "Topology":
        """The paper's 2-node testbed: primary = hub, auxiliary = spoke."""
        return Topology([primary, auxiliary], [None, link], kind="pair")

    @staticmethod
    def star(hub: NodeGroup, spokes: Sequence[NodeGroup],
             links: Union[LinkModel, Sequence[LinkModel]],
             prefill_spoke: Optional[Union[int, str]] = None) -> "Topology":
        """§VIII star: one hub, G−1 spokes, one link per spoke (a single
        LinkModel is broadcast to every edge).  ``prefill_spoke`` (a group
        index 1.., or a spoke's name) dedicates that spoke to
        disaggregated prefill — it serves KV blocks, not decode waves."""
        spokes = list(spokes)
        if isinstance(links, LinkModel):
            links = [links] * len(spokes)
        if isinstance(prefill_spoke, str):
            names = [hub.name] + [s.name for s in spokes]
            if prefill_spoke not in names[1:]:
                raise ValueError(f"no spoke named {prefill_spoke!r} "
                                 f"(have {names[1:]})")
            prefill_spoke = names.index(prefill_spoke)
        return Topology([hub, *spokes], [None, *links], kind="star",
                        prefill_spoke=prefill_spoke)


# ---------------------------------------------------------------------------
def group_times_from_fits(T2, spoke_fits) -> Callable:
    """Adapter: Eq. 1-3 polynomial fits → ``solve_star`` group_time_fn.

    ``T2`` is the hub's fitted exec time *vs r* (the paper stores the
    primary's curve against the offloaded share, so the hub running
    fraction f0 costs T2(1 − f0)); ``spoke_fits`` is [(T1_g, T3_g), ...]
    per spoke, each evaluated at that spoke's own fraction.  The returned
    function maps f [G] to a float32 tensor [G] that ``solve_star`` can
    differentiate through.
    """
    def group_time_fn(f):
        ts = [T2(1.0 - f[0])]
        for g, (T1, T3) in enumerate(spoke_fits, start=1):
            ts.append(T1(f[g]) + T3(f[g]))
        return torch.stack(ts)
    return group_time_fn


# ---------------------------------------------------------------------------
@dataclass
class TaskSpec:
    """One registered workload: a model config + params, with one
    continuous-batching engine per decode group (groups on one device with
    the same kernel setting share the prefill/step/loop closures)."""
    name: str
    cfg: Any
    params: Any
    engines: Dict[str, ContinuousServingEngine]
    payload_bytes_per_item: float
    max_new: Optional[int]        # per-task generation cap (None = only
                                  # each request's own max_new applies)
    prefill_worker: Any = None    # PrefillWorker / PrefillWorkerPool on the
                                  # dedicated prefill group (None without a
                                  # prefill_spoke)
    prefix_cache: Any = None      # PrefixCache shared by every decode
                                  # engine of this task (hub-side trie;
                                  # None when the cache is disabled)


@dataclass
class ServeResult:
    """Outputs + structured telemetry from one ``HeteroRuntime.serve``."""
    outputs: Dict[str, List[RequestOutput]]   # task name → per-request
    telemetry: dict = field(default_factory=dict)

    def to_json(self, **kw) -> str:
        return json.dumps(self.telemetry, **kw)


# ---------------------------------------------------------------------------
# The additive serving counters, each with its zero (its telemetry type) and
# the levels that publish it: "g" per_group, "w" the wave, "t" the totals.
# A group sums its engine runs' ContinuousStats, a wave its groups, the
# totals the waves.  The unpublished ones feed derived fields and the router.
_COUNTERS = (
    ("tokens", 0, "gwt"), ("host_syncs", 0, "gwt"),
    ("admission_stalls", 0, "gwt"), ("prefill_offloaded", 0, "gwt"),
    ("prefill_fallbacks", 0, "gwt"), ("t_kv_transfer_s", 0.0, "gwt"),
    ("prefix_hits", 0, "gwt"), ("prefix_blocks_reused", 0, "gwt"),
    ("prefill_flops_avoided", 0.0, "gwt"), ("prefill_flops_total", 0.0, "t"),
    ("kv_hop_bytes_raw", 0.0, "gwt"), ("kv_hop_bytes_wire", 0.0, "gwt"),
    ("wave_launches", 0, "gt"), ("t_prefill_overlap_s", 0.0, "gt"),
    ("t_splice_s", 0.0, "gt"), ("t_slot_write_s", 0.0, "gt"),
    ("t_dispatch_s", 0.0, "gt"), ("t_await_s", 0.0, "gt"),
    ("decode_s", 0.0, ""), ("macro_dispatches", 0, ""),
    ("shadow_prefills", 0, ""),
    ("decode_graph_steps", 0, "gwt"),
    ("decode_eager_steps", 0, "gwt"),
    ("decode_graph_captures", 0, "gwt"),
)
_ZEROS = {name: zero for name, zero, _ in _COUNTERS}
_LEVELS = {name: levels for name, _, levels in _COUNTERS}


def _fold(records) -> Dict[str, Any]:
    """Sum serving records counter by counter, each from its own zero, so
    that no records (a dead group, an empty share) still give the
    telemetry's types."""
    out = dict(_ZEROS)
    for r in records:
        for name in out:
            out[name] += r[name]
    return out


def _published(rec: dict, level: str) -> dict:
    """``rec`` less the counters that ``level`` does not publish."""
    return {k: v for k, v in rec.items() if level in _LEVELS.get(k, level)}


def _per_macro_step(rec: dict) -> float:
    """Decode wall a fused macro-step (0.0 where none was dispatched)."""
    n = rec["macro_dispatches"]
    return rec["decode_s"] / n if n else 0.0


class _WavePlan(NamedTuple):
    """What the fault domain decided for one wave."""
    sv: SplitVector
    counts: Tuple[int, ...]           # per decode group, hub first
    n_latched: int                    # edges the β latch forced local
    rerouted: int                     # requests the hot mask moved
    link_bw: Dict[str, float]         # live rate per group (hub 0.0)
    links: Dict[int, Tuple[LinkModel, float]]   # traced edges' link, distance
    adm: list                         # per decode group admission assessment
    route: Any                        # prefill route (None without a spoke)


class HeteroRuntime:
    """Session facade over the whole HeteroEdge pipeline.

        topo = Topology.star(hub, [s1, s2], C.WIFI_5GHZ)
        rt = HeteroRuntime(topo, slots=4, max_len=64)
        rt.add_task("posenet", cfg_a, params_a)
        rt.add_task("segnet", cfg_b, params_b)
        result = rt.serve(requests)        # ServeRequest.task routes each
        print(result.to_json(indent=2))

    Requests are drained in arrival-order waves of ``2·slots·(D−1)``
    (D = decode groups); each wave is apportioned across the decode
    groups by the live :class:`SplitVector` (online controller: Eq. 4
    when two groups decode, ``solve_star`` beyond), every group's
    continuous-batching engines drain their share per task, and the
    measured per-group wall clocks feed back into the controller for the
    next wave.

    A topology with a ``prefill_spoke`` disaggregates prefill: that spoke
    takes no decode waves — instead every task gets a
    :class:`~repro_torch.serving.prefill.PrefillWorker` on it, and the
    :class:`PrefillRouter` decides per wave whether shadow prefills ship
    there (pricing the KV-transfer hop with the spoke's LinkModel) or
    stay local, falling back to local shadow prefill when the group is
    absent, dead, or slower.

    Each group's engines run on ``group.devices[0]`` (groups on one card
    share it), and the prefill workers on the prefill group's first device.
    """

    def __init__(self, topology: Topology, *, slots: int = 4,
                 max_len: int = 64, macro_steps: int = 8,
                 wave_steps: int = 1,
                 overlap_admission: bool = True,
                 controller: Optional[SplitRatioController] = None,
                 prefill_router: Optional[PrefillRouter] = None,
                 link_distance: float = 1.0,
                 prefix_cache_blocks: int = 0, prefix_block_size: int = 8,
                 prefill_pool: int = 1,
                 kv_keep_rate: Optional[float] = None,
                 link_traces: Optional[Dict[Union[int, str],
                                            LinkTrace]] = None,
                 reprobe_after: int = 2, reprobe_max: int = 32,
                 group_budgets: Optional[Dict[str, GroupBudget]] = None):
        self.topology = topology
        self.slots = slots
        self.max_len = max_len
        self.macro_steps = macro_steps   # fused decode tokens per dispatch
                                         # (0 = pre-fusion per-token loop)
        self.wave_steps = int(wave_steps)  # fused macro-steps per host
                                           # launch (>1 = the wave driver;
                                           # needs macro_steps>0)
        self.overlap_admission = bool(overlap_admission)
        # shadow-slot speculative prefill behind the fused decode loop
        # (ignored on the macro_steps=0 per-token path)
        self.link_distance = link_distance
        # content-aware KV reuse: >0 arms a per-task radix prefix
        # cache of that many fixed-size KV blocks, shared hub-side by
        # every decode engine of the task — matched spans skip prefill
        # and (disaggregated) the KV hop ships compacted tails only
        self.prefix_cache_blocks = int(prefix_cache_blocks)
        self.prefix_block_size = int(prefix_block_size)
        # >1 puts a PrefillWorkerPool (content-hash affinity + failover)
        # on the prefill spoke instead of a single serializing worker
        self.prefill_pool = int(prefill_pool)
        if self.prefill_pool < 1:
            raise ValueError(f"prefill_pool must be >= 1, got {prefill_pool}")
        # gated LOSSY hop knob — None (default) keeps hops lossless
        self.kv_keep_rate = kv_keep_rate
        # mobility-driven link churn: per-edge LinkTrace replayed
        # on the serve wave clock, keyed by spoke index (1..) or group
        # name — the hub has no link, so it can't be traced
        self.link_traces: Dict[int, LinkTrace] = {}
        names = [g.name for g in topology.groups]
        for key, tr in (link_traces or {}).items():
            if isinstance(key, str):
                if key not in names:
                    raise ValueError(f"link_traces key {key!r} names no "
                                     f"group (have {names})")
                gi = names.index(key)
            else:
                gi = int(key)
            if not 1 <= gi < len(names):
                raise ValueError(
                    f"link_traces key {key!r} must name a spoke "
                    f"(1..{len(names) - 1}) — the hub crosses no link")
            self.link_traces[gi] = tr
        # dead-group re-probe clock bounds (the PrefillRouter shares the
        # same Backoff helper and defaults)
        self.reprobe_after = int(reprobe_after)
        self.reprobe_max = int(reprobe_max)
        # workers killed BY the prefill group's health (vs. worker-level
        # faults): persists across serve calls so a group restore()
        # between calls still revives exactly the workers we killed
        self._pf_group_killed = False
        # decode waves are split over every group EXCEPT the dedicated
        # prefill spoke (when one is marked) — that group serves KV blocks
        self._decode = topology.decode_indices()
        # power/memory/busy-factor admission: ALWAYS armed — the
        # default budgets are cold (wall power, λ memory gate), so the
        # headroom telemetry is populated whether or not the operator
        # budgets any group; hot groups mask out of the split below
        self.admission = AdmissionController(
            [topology.groups[gi] for gi in self._decode],
            budgets=group_budgets)
        D = len(self._decode)
        if D >= 2:
            self.controller = controller or SplitRatioController(
                ControllerConfig(update_every=2), n_groups=D)
            if self.controller.n_groups != D:
                raise ValueError(
                    f"controller is sized for {self.controller.n_groups} "
                    f"groups but the topology has {D} decode groups")
        else:
            # pure disaggregation (hub decodes, spoke prefills): there is
            # nothing to split — the controller is bypassed
            if controller is not None:
                raise ValueError("a controller needs >= 2 decode groups; "
                                 "this topology has 1 (hub only)")
            self.controller = None
        self.prefill_router: Optional[PrefillRouter] = None
        if topology.prefill_spoke is not None:
            if self.macro_steps == 0 or not self.overlap_admission:
                raise ValueError(
                    "a prefill_spoke needs the overlapped fused path "
                    "(macro_steps > 0, overlap_admission=True) — "
                    "otherwise the dedicated group would idle while its "
                    "decode capacity is already carved out")
            self.prefill_router = prefill_router or PrefillRouter(
                topology.prefill_link, distance=link_distance)
        elif prefill_router is not None:
            raise ValueError("prefill_router given but the topology marks "
                             "no prefill_spoke")
        self.tasks: Dict[str, TaskSpec] = {}

    # ------------------------------------------------------------------
    def add_task(self, name: str, cfg, params, *,
                 max_new: Optional[int] = None,
                 max_len: Optional[int] = None,
                 payload_bytes_per_item: Optional[float] = None) -> TaskSpec:
        """Register a workload in the session's multi-task registry: one
        slot-based engine per decode group, on the group's first device (a
        group on another device than ``params`` gets its own copy of them).
        ``max_new`` caps every request of this task (requests asking for
        more are clamped at dispatch)."""
        if name in self.tasks:
            raise ValueError(f"task {name!r} already registered")
        ml = max_len or self.max_len
        worker = None
        pg = self.topology.prefill_group
        if pg is not None:
            from repro_torch.serving.prefill import (PrefillWorker,
                                                     PrefillWorkerPool)
            kw = dict(device=pg.devices[0], link=self.topology.prefill_link,
                      distance=self.link_distance, name=pg.name,
                      kv_keep_rate=self.kv_keep_rate)
            worker = (PrefillWorkerPool(cfg, params, size=self.prefill_pool,
                                        **kw) if self.prefill_pool > 1
                      else PrefillWorker(cfg, params, **kw))
        pcache = None
        if self.prefix_cache_blocks > 0:
            from repro_torch.serving.prefix_cache import PrefixCache
            # ONE trie per task, shared by every decode engine: the trie
            # lives hub-side with the admission loop, so a prefix served
            # on any group seeds hits for the whole session — and with a
            # prefill spoke it is consulted BEFORE dispatch, so full
            # hits never cross the wire at all
            pcache = PrefixCache(cfg, block_size=self.prefix_block_size,
                                 budget_blocks=self.prefix_cache_blocks,
                                 device=self.topology.hub.devices[0])
        engines: Dict[str, ContinuousServingEngine] = {}
        first: Optional[ContinuousServingEngine] = None
        overlap = self.overlap_admission
        on_device: Dict[torch.device, Any] = {}
        for gi in self._decode:
            grp = self.topology.groups[gi]
            dev = torch.device(grp.devices[0])
            if dev not in on_device:
                # Tensor.to returns the tensor itself where it already is
                on_device[dev] = tree_map(lambda t: t.to(dev), params)
            eng = _engine.ContinuousServingEngine(
                cfg, on_device[dev], slots=self.slots, max_len=ml,
                macro_steps=self.macro_steps, wave_steps=self.wave_steps,
                overlap_admission=overlap, prefill_worker=worker,
                prefix_cache=pcache, share_from=first, device=dev)
            engines[grp.name] = eng
            first = first or eng
        payload = payload_bytes_per_item
        if payload is None:
            payload = float(getattr(cfg, "d_model", 256)) * 2.0 * 16
        spec = TaskSpec(name=name, cfg=cfg, params=params, engines=engines,
                        payload_bytes_per_item=payload, max_new=max_new,
                        prefill_worker=worker, prefix_cache=pcache)
        self.tasks[name] = spec
        # every decode group hosts one engine of this task: its analytic
        # cache footprint joins the admission ledger (memory headroom)
        self.admission.add_task_bytes(kv_cache_bytes(cfg, self.slots, ml))
        return spec

    # ------------------------------------------------------------------
    @staticmethod
    def _capped(spec: TaskSpec,
                reqs: List[ServeRequest]) -> List[ServeRequest]:
        """Apply the task's max_new cap (requests are never mutated)."""
        if spec.max_new is None:
            return reqs
        return [dataclasses.replace(r, max_new=min(r.max_new, spec.max_new))
                if r.max_new > spec.max_new else r for r in reqs]

    def _task_of(self, req: ServeRequest) -> str:
        task = getattr(req, "task", "") or ""
        if task:
            if task not in self.tasks:
                raise KeyError(f"request {req.uid} names unregistered task "
                               f"{task!r} (have {sorted(self.tasks)})")
            return task
        if len(self.tasks) == 1:
            return next(iter(self.tasks))
        raise KeyError(f"request {req.uid} is untagged but "
                       f"{len(self.tasks)} tasks are registered")

    def _split_for(self, n: int, split,
                   alive: Optional[Tuple[bool, ...]] = None
                   ) -> Tuple[SplitVector, Tuple[int, ...]]:
        """Resolve this wave's SplitVector + per-DECODE-group counts
        (hub first; the dedicated prefill spoke takes no decode share).
        ``split``: None → live controller (with its exploration floor),
        scalar r or SplitVector/sequence → fixed.  ``alive`` masks dead
        decode groups onto the surviving simplex (exactly 0 items)."""
        D = len(self._decode)
        if alive is not None and all(alive):
            alive = None
        if D == 1:
            # pure disaggregation: the hub is the only decode group — an
            # explicit split is only accepted when it says exactly that
            # (r=0 / all-hub); anything else is a misconfiguration, not
            # something to silently ignore
            if split is not None:
                ok = (isinstance(split, (int, float))
                      and float(split) == 0.0) \
                    or (isinstance(split, SplitVector) and len(split) == 1) \
                    or (not isinstance(split, (int, float, SplitVector))
                        and len(tuple(split)) == 1)
                if not ok:
                    raise ValueError(
                        f"split {split!r} given, but this topology has 1 "
                        "decode group (pure disaggregation) — only "
                        "split=None, 0.0 or a 1-element vector is valid")
            return SplitVector((1.0,)), (n,)
        if split is None:
            self.controller.set_alive(alive if alive is not None
                                      else (True,) * D)
            counts = self.controller.split_counts(n)
            return SplitVector(self.controller.fractions), counts
        if isinstance(split, SplitVector):
            sv = split
        elif isinstance(split, (int, float)):
            sv = SplitVector.from_r(float(split), D)
        else:
            sv = SplitVector(tuple(split))
        if len(sv) != D:
            raise ValueError(f"split has {len(sv)} fractions for {D} "
                             "decode groups")
        if alive is not None:
            sv = sv.masked(alive)
        return sv, sv.counts(n)

    def warmup(self, requests: Sequence[ServeRequest]) -> None:
        """Run one representative request of each task through every
        group's engine so wave timings measure steady-state serving."""
        seen = set()
        for req in requests:
            task = self._task_of(req)
            if task in seen:
                continue
            seen.add(task)
            spec = self.tasks[task]
            for eng in spec.engines.values():
                eng.run(self._capped(spec, [req]))

    # ------------------------------------------------------------------
    def _plan_wave(self, wave_idx: int, n: int, split,
                   dead: Dict[int, Backoff]) -> _WavePlan:
        """The fleet's fault domain for one wave of ``n`` requests: re-probe
        the dead decode groups (``dead`` is updated in place), carry the
        prefill spoke's health to its workers, replay the link traces, mask
        the split onto the live, unlatched, cold groups and pick the
        prefill route."""
        topo = self.topology
        decode = self._decode
        workers = [spec.prefill_worker for spec in self.tasks.values()
                   if spec.prefill_worker is not None]
        # 1) bounded-backoff re-probe of dead decode groups: a restored
        # group rejoins on the wave clock, a still-dead probe doubles the
        # wait (the PrefillRouter's Backoff)
        for gi, bo in list(dead.items()):
            if bo.tick():
                if topo.groups[gi].health.alive:
                    del dead[gi]
                else:
                    bo.fail()

        # 2) the prefill spoke's NodeGroup health runs on the same wave
        # clock: a group-level kill (or armed fault firing now) propagates
        # to its workers so the router latches local this wave; a
        # group-level restore revives exactly the workers this path killed,
        # and the router's own backoff re-probes
        pfg = topo.prefill_group
        if pfg is not None:
            try:
                pfg.health.check("dispatch", pfg.name)
            except GroupUnavailableError:
                pass
            if not pfg.health.alive and not self._pf_group_killed:
                for w in workers:
                    w.kill()
                self._pf_group_killed = True
            elif pfg.health.alive and self._pf_group_killed:
                for w in workers:
                    w.restore()
                self._pf_group_killed = False

        # 3) mobility-driven link churn (paper §V-A.5): replay every traced
        # edge at this wave — live LinkModel, β latch, and the traced
        # bandwidth the telemetry and hop prices follow
        latched: Dict[int, bool] = {}
        links: Dict[int, Tuple[LinkModel, float]] = {}
        link_bw = {g.name: 0.0 for g in topo.groups}
        for gi in range(1, len(topo.groups)):
            name = topo.groups[gi].name
            tr = self.link_traces.get(gi)
            if tr is None:
                link_bw[name] = float(data_rate(topo.links[gi],
                                                self.link_distance))
                continue
            eff = tr.link_at(topo.links[gi], wave_idx)
            d_m = tr.distance_at(wave_idx)
            feasible = tr.feasible(wave_idx)
            links[gi] = (eff, d_m)
            link_bw[name] = float(data_rate(eff, d_m))
            if gi == topo.prefill_spoke:
                self.prefill_router.link = eff
                self.prefill_router.distance = d_m
                self.prefill_router.mobility_latched = not feasible
                for w in workers:
                    w.set_link(eff, d_m)
            else:
                latched[gi] = not feasible
        n_latched = sum(latched.values()) + (
            1 if self.prefill_router is not None
            and self.prefill_router.mobility_latched else 0)

        # 4) surviving simplex: dead groups mask to exactly 0; the β latch
        # additionally zeroes priced-out edges while at least one unlatched
        # live group remains (death is hard, the latch is advisory — an
        # all-latched fleet still has to decode)
        alive_mask = tuple(gi not in dead for gi in decode)
        if not any(alive_mask):
            raise GroupUnavailableError(
                "all", "every decode group is dead — restore one before "
                "serving")
        eff_mask = tuple(a and not latched.get(gi, False)
                         for a, gi in zip(alive_mask, decode))
        if not any(eff_mask):
            eff_mask = alive_mask

        # 5) power/memory/busy-factor admission: groups whose budget runs
        # hot mask out of the split — the same masked-simplex path that
        # removes dead groups — and their share re-routes to the cold
        # survivors.  Like the β latch, hotness is advisory: an all-hot
        # fleet still decodes (the frontend sheds in that regime instead)
        adm = self.admission.assess()
        adm_mask = tuple(e and not a.hot for e, a in zip(eff_mask, adm))
        rerouted = 0
        if any(adm_mask) and adm_mask != eff_mask:
            _, counts_base = self._split_for(n, split, eff_mask)
            rerouted = sum(c for c, keep in zip(counts_base, adm_mask)
                           if not keep)
            eff_mask = adm_mask
        sv, counts = self._split_for(n, split, eff_mask)

        # 6) the prefill route
        route = None
        if self.prefill_router is not None:
            # a worker that died outside a counted wave (warmup, or a direct
            # engine run) must still flip the route to local
            alive = any(w.healthy for w in workers)
            if not alive:
                self.prefill_router.healthy = False
            # bounded-backoff auto re-probe: a latched-local router flips
            # back on its own once a probe wave finds the prefill group
            # restored — no operator revive()
            self.prefill_router.maybe_revive(alive)
            route = self.prefill_router.route()
            for spec in self.tasks.values():
                for eng in spec.engines.values():
                    eng.prefill_remote = route.remote
        return _WavePlan(sv, tuple(counts), n_latched, rerouted, link_bw,
                         links, adm, route)

    def _run_group(self, gi: int, share: List[ServeRequest],
                   links: Dict[int, Tuple[LinkModel, float]],
                   on_tokens) -> Tuple[Optional[list], dict]:
        """Run decode group ``gi``'s share of a wave, task by task: its runs
        ``(task, outputs, stats)`` and its record, the runs' stats folded
        with its wall, link latency and requests by task.  A group that
        dies mid-wave gives no runs (None) and a record of zeros."""
        grp = self.topology.groups[gi]
        by_task: Dict[str, List[ServeRequest]] = {}
        for req in share:
            by_task.setdefault(self._task_of(req), []).append(req)
        runs = []
        payload = 0.0
        with tracing.timed("runtime.group", group=grp.name) as sp_g:
            try:
                if share:
                    grp.health.check("dispatch", grp.name)
                for task, reqs_t in by_task.items():
                    spec = self.tasks[task]
                    outs, st = spec.engines[grp.name].run(
                        self._capped(spec, reqs_t), on_tokens=on_tokens)
                    runs.append((task, outs, st))
                    payload += len(reqs_t) * spec.payload_bytes_per_item
                if share:
                    grp.health.check("await", grp.name)
            except GroupUnavailableError:
                return None, {"n": 0, "wall_s": 0.0, "link_s": 0.0, **_ZEROS,
                              "t_per_macro_step_s": 0.0, "tasks": {}}
        link_s = 0.0
        if gi > 0 and share:
            eff_link, eff_dist = links.get(
                gi, (self.topology.links[gi], self.link_distance))
            link_s = float(offload_latency(eff_link, payload, eff_dist))
        rec = _fold(dict(vars(st), tokens=st.total_tokens)
                    for _, _, st in runs)
        return runs, {"n": len(share), "wall_s": sp_g.seconds,
                      "link_s": link_s, **rec,
                      "t_per_macro_step_s": _per_macro_step(rec),
                      "tasks": {t: len(r) for t, r in by_task.items()}}

    def serve(self, requests: Sequence[ServeRequest], *, split=None,
              wave: Optional[int] = None, warm: bool = True,
              verbose: bool = False,
              on_tokens: Optional[Callable[[int, int, List[int]],
                                           None]] = None) -> ServeResult:
        """Drain a (possibly mixed-task) request stream through the
        topology.  Returns outputs per task + structured telemetry.

        A wave takes the queue's next chunk, decides its split
        (:meth:`_plan_wave`), runs each decode group (:meth:`_run_group`),
        folds their records, feeds the controller and the prefill router,
        and requeues the share of a group that died mid-wave.

        With a dedicated prefill spoke, every wave first consults the
        :class:`PrefillRouter`: shadow prefills are shipped to the prefill
        group only while its priced cost (remote prefill + KV-transfer
        hop) beats local shadow prefill AND the group is healthy — a
        mid-wave failure falls back inside the engines (bit-identical
        streams) and latches the router to local.

        ``on_tokens(uid, start, tokens)`` (optional) streams host-side
        token landings live: ``start`` is the stream position of the
        first token in the chunk, so a re-queued request replayed on a
        survivor (bit-identical prefix) can be deduplicated by position
        — the :class:`~repro_torch.serving.frontend.ServingFrontend` is the
        intended consumer.  Warmup runs never stream."""
        with tracing.span("runtime.serve"):
            if not self.tasks:
                raise RuntimeError("no tasks registered — call add_task first")
            topo = self.topology
            decode = self._decode
            wave = wave or 2 * self.slots * max(len(decode) - 1, 1)
            requests = list(requests)
            if warm and requests:
                self.warmup(requests[:max(len(self.tasks) * 2, 4)])

            outputs: Dict[str, List[RequestOutput]] = {t: [] for t in self.tasks}
            waves_tel: List[dict] = []
            wave_recs: List[dict] = []
            retried_uids: set = set()
            dead: Dict[int, Backoff] = {}     # topology group index → re-probe
            names = tuple(topo.groups[gi].name for gi in decode)
            queue: List[ServeRequest] = list(requests)
            t_start = time.perf_counter()
            while queue:
                wave_idx = len(waves_tel)
                chunk, queue = queue[:wave], queue[wave:]
                plan = self._plan_wave(wave_idx, len(chunk), split, dead)
                counts = list(plan.counts)

                # partition: decode spokes take the front of the wave in
                # topology order, the hub keeps the tail (the [aux; pri]
                # layout of OffloadEngine); the prefill spoke takes no
                # decode share
                cuts = list(itertools.accumulate(counts[1:], initial=0))
                shares = [chunk[cuts[-1]:]] + [
                    chunk[a:b] for a, b in zip(cuts, cuts[1:])]

                recs: List[dict] = []
                requeue: List[ServeRequest] = []
                with tracing.timed("runtime.wave", wave=wave_idx) as sp_w:
                    for d, gi in enumerate(decode):
                        runs, rec = self._run_group(gi, shares[d], plan.links,
                                                    on_tokens)
                        if runs is None:
                            # the group died mid-wave: its slice re-queues
                            # onto the survivors and its re-probe clock starts
                            dead[gi] = Backoff(self.reprobe_after,
                                               self.reprobe_max)
                            requeue.extend(shares[d])
                            counts[d] = 0
                        else:
                            for task, outs, _ in runs:
                                outputs[task].extend(outs)
                        recs.append(rec)
                wall = sp_w.seconds
                t_group = [g["wall_s"] for g in recs]
                t_link = [g["link_s"] for g in recs]
                wave_rec = _fold(recs)
                wave_recs.append(wave_rec)
                # the measured group walls drain the admission controller's
                # battery clocks (Eq. 5's t_dnn) for the NEXT wave's headroom
                for name, t in zip(names, t_group):
                    self.admission.charge(name, t)
                # commit the wave's failures: requests from dead groups go
                # back to the FRONT of the queue (same serve call, next wave)
                requeue_uids = {r.uid for r in requeue}
                wave_retries = sum(1 for r in chunk
                                   if r.uid in retried_uids
                                   and r.uid not in requeue_uids)
                retried_uids.update(requeue_uids)
                queue = requeue + queue
                # the prefill spoke's is the routing-effective liveness:
                # group health AND worker health, as the router saw it
                group_alive = {g.name: gi not in dead
                               if gi != topo.prefill_spoke
                               else bool(self.prefill_router.healthy)
                               for gi, g in enumerate(topo.groups)}
                alive_after = tuple(group_alive[n] for n in names)
                if split is None and self.controller is not None:
                    self.controller.observe(OffloadReport(
                        r=plan.sv.r, n_local=counts[0],
                        n_offloaded=sum(counts[1:]), t_local_s=t_group[0],
                        t_remote_s=max(t_group[1:], default=0.0),
                        t_offload_s=max(t_link[1:], default=0.0),
                        payload_bytes=0.0, e_offload_j=0.0,
                        group_names=names, n_group=tuple(counts),
                        t_group_s=tuple(t_group), t_link_s=tuple(t_link),
                        group_alive=alive_after, wave_requeued=len(requeue),
                        wave_retries=wave_retries,
                        link_bw_hz=tuple(plan.link_bw[n] for n in names),
                        mobility_latched=plan.n_latched,
                        admission_hot=tuple(a.hot for a in plan.adm),
                        admission_rerouted=plan.rerouted,
                        power_headroom_w=tuple(a.power_headroom_w
                                               for a in plan.adm),
                        mem_headroom_frac=tuple(a.mem_headroom_frac
                                                for a in plan.adm),
                        **{k: v for k, v in wave_rec.items()
                           if k in OffloadReport.__dataclass_fields__}))
                if self.prefill_router is not None:
                    # feed the router the wave's live prices.  The engines'
                    # t_prefill_overlap_s wall covers exactly the TOP-UP
                    # shadow dispatches (shadow_prefills), local and remote
                    # alike — so both rates divide that wall by the top-up
                    # count; inline boundary dispatches are excluded from
                    # both sides.  KV hops are per TRANSFERRED block
                    # (prefill_offloaded, inline offloads included).
                    n_off = wave_rec["prefill_offloaded"]
                    n_topup = wave_rec["shadow_prefills"]
                    overlap_s = wave_rec["t_prefill_overlap_s"]
                    ftotal = wave_rec["prefill_flops_total"]
                    self.prefill_router.observe(
                        local_s=overlap_s if n_off == 0 else 0.0,
                        n_local=n_topup if n_off == 0 else 0,
                        remote_s=overlap_s if n_off else 0.0,
                        n_remote=n_topup if n_off else 0,
                        transfer_s=wave_rec["t_kv_transfer_s"], n_transfers=n_off,
                        # price hops on WIRE bytes — what the link carried —
                        # and the residual prefill fraction the cache left
                        payload_bytes=wave_rec["kv_hop_bytes_wire"],
                        prefix_residual=(1.0 - wave_rec["prefill_flops_avoided"]
                                         / ftotal) if ftotal > 0 else None,
                        fallbacks=wave_rec["prefill_fallbacks"])
                waves_tel.append({
                    "wave": wave_idx, "n": len(chunk),
                    "split": [round(float(f), 4) for f in plan.sv.fractions],
                    "counts": [int(c) for c in counts], "wall_s": wall,
                    **_published(wave_rec, "w"),
                    "prefill_route": ("remote" if plan.route is not None
                                      and plan.route.remote else "local"),
                    "group_alive": group_alive,
                    "wave_requeued": len(requeue),
                    "wave_retries": wave_retries,
                    "link_bw_hz": dict(plan.link_bw),
                    "mobility_latched": plan.n_latched,
                    "admission_hot": {a.name: a.hot for a in plan.adm},
                    "admission_rerouted": plan.rerouted,
                    "power_headroom_w": {a.name: round(a.power_headroom_w, 6)
                                         for a in plan.adm},
                    "mem_headroom_frac": {a.name: round(a.mem_headroom_frac, 6)
                                          for a in plan.adm},
                    "per_group": {n: _published(g, "g")
                                  for n, g in zip(names, recs)}})
                if verbose:
                    print(f"wave {wave_idx}: {len(chunk):2d} reqs split="
                          f"{'/'.join(str(c) for c in counts)} {wave_rec['tokens']}"
                          f" toks in {wall:.2f}s "
                          f"({wave_rec['tokens'] / max(wall, 1e-9):.1f} tok/s)")

            wall_total = time.perf_counter() - t_start
            for outs in outputs.values():
                outs.sort(key=lambda o: o.uid)
            run = _fold(wave_recs)
            last = waves_tel[-1] if waves_tel else {}
            pg = topo.prefill_group
            telemetry = {
                "topology": topo.kind,
                "groups": [g.name for g in topo.groups],
                "prefill_group": pg.name if pg is not None else "",
                **{k: getattr(self, k) for k in (
                    "slots", "macro_steps", "wave_steps", "overlap_admission")},
                "tasks": sorted(self.tasks),
                "waves": waves_tel,
                "totals": {
                    "requests": len(requests), "wall_s": wall_total,
                    **_published(run, "t"),
                    "tok_per_s": run["tokens"] / max(wall_total, 1e-9),
                    "host_syncs_per_token": run["host_syncs"]
                    / max(run["tokens"], 1),
                    "t_per_macro_step_s": _per_macro_step(run),
                    "prefill_flops_avoided_frac":
                    run["prefill_flops_avoided"] / run["prefill_flops_total"]
                    if run["prefill_flops_total"] else 0.0,
                    # the waves' own counters, summed
                    **{k: sum(w[k] for w in waves_tel)
                       for k in ("wave_requeued", "wave_retries",
                                 "mobility_latched", "admission_rerouted")},
                    # the fleet as the last wave left it
                    **{k: dict(last.get(k, {}))
                       for k in ("admission_hot", "power_headroom_w",
                                 "mem_headroom_frac", "group_alive",
                                 "link_bw_hz")},
                    "final_split": [round(float(f), 4) for f in (
                        self.controller.fractions
                        if split is None and self.controller is not None
                        else self._split_for(max(len(requests), 1),
                                             split)[0].fractions)],
                },
            }
            return ServeResult(outputs=outputs, telemetry=telemetry)
