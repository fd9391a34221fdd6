"""Power / memory / busy-factor admission (paper §V-A.3-4).

The paper's optimizer treats busy factor, power budget and memory
availability as *boundary conditions* on where work may run.  This module
turns them into a per-wave admission assessment that
:class:`~repro_torch.core.topology.HeteroRuntime` folds into its
masked-simplex split (the same ``SplitRatioController.set_alive`` path that
removes dead groups):

* **power** — each decode group may carry a :class:`GroupBudget` with a
  :class:`~repro_torch.core.battery.BatteryState` power envelope (on cards:
  a power cap or an energy quota per serving window).  The group's
  accumulated serve wall is the ``t_dnn`` drain of Eqs. 5-6;
  ``offload_pressure`` ≥ ``pressure_hot`` marks the group hot.
* **memory** — the registered tasks' KV-cache bytes against the group
  profile's memory, gated by the availability factor λ (Algorithm 1 line
  3, the same ``lambda_mem`` default as ``SchedulerConfig``).
* **busy factor** — a background job consuming ≥ ``busy_max`` of the
  group's compute prices the group out of new admissions.

Hotness is ADVISORY, like the mobility β latch: a hot group is masked out
of the split while at least one cold live group remains; an all-hot fleet
still has to decode (the frontend sheds load in that regime, see
:mod:`repro_torch.serving.frontend`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.battery import (BatteryState, available_power,
                                      offload_pressure)
from repro_torch.core.offload import tree_leaves


def kv_cache_bytes(cfg, slots: int, max_len: int) -> float:
    """Analytic KV/state-cache footprint of one engine: the byte count of
    ``init_cache(cfg, slots, max_len)`` built on the meta device, so
    nothing is allocated (an int8 cache counts its values and f32 scales,
    the audio decoder its cross cache)."""
    from repro_torch.models import model as M
    shapes = M.init_cache(cfg, slots, max_len, dtype=cfg.torch_dtype,
                          device="meta")
    return float(sum(t.numel() * t.element_size()
                     for t in tree_leaves(shapes)))


@dataclass(frozen=True)
class GroupBudget:
    """Per-decode-group admission envelope.  The default budget is
    *cold*: no battery (unbounded power), the paper's λ memory gate, and
    a busy-factor ceiling that only trips under near-total contention."""
    battery: Optional[BatteryState] = None  # power envelope (Eqs. 5-6);
                                            # None = wall power, never hot
    power_threshold_w: float = 8.0          # P_available floor (W)
    pressure_hot: float = 0.5               # offload_pressure ≥ this → hot
    mem_lambda: float = 0.95                # availability factor λ
    busy_max: float = 0.9                   # background-load ceiling


@dataclass
class GroupAdmission:
    """One group's assessment for one wave (telemetry-facing)."""
    name: str
    hot: bool
    reason: str                 # "" | "power" | "memory" | "busy"
    power_headroom_w: float     # P_available − threshold (∞ → capped)
    mem_headroom_frac: float    # λ − kv_bytes / (chips·HBM)
    pressure: float             # battery offload_pressure ∈ [0,1]
    busy_factor: float


class AdmissionController:
    """Wave-clock assessment of every decode group's boundary conditions.

    Stateful-but-small like :class:`TaskScheduler`: the only mutable
    state is each group's accumulated serve wall (the battery drain
    clock) and the registered tasks' cache footprint.  ``assess`` is
    pure read-out — the runtime folds the hot mask into its split and
    the frontend consults ``fleet_hot`` to shed."""

    def __init__(self, groups: Sequence, *,
                 budgets: Optional[Dict[str, GroupBudget]] = None):
        self.groups = list(groups)          # decode NodeGroups, hub first
        names = [g.name for g in self.groups]
        for key in (budgets or {}):
            if key not in names:
                raise ValueError(f"group_budgets key {key!r} names no "
                                 f"decode group (have {names})")
        self.budgets = {g.name: (budgets or {}).get(g.name, GroupBudget())
                        for g in self.groups}
        self.kv_bytes = 0.0                 # per-group engine footprint
        self._active_s = {g.name: 0.0 for g in self.groups}

    # -- wave-clock inputs --------------------------------------------
    def add_task_bytes(self, n_bytes: float) -> None:
        """Every decode group hosts one engine per task, so one task adds
        the same cache footprint to each group's ledger."""
        self.kv_bytes += float(n_bytes)

    def charge(self, name: str, wall_s: float) -> None:
        """Accumulate a group's measured serve wall — the ``t_dnn`` drain
        of the battery envelope (Eq. 5)."""
        self._active_s[name] += float(wall_s)

    # -- assessment ---------------------------------------------------
    def _assess_group(self, grp) -> GroupAdmission:
        b = self.budgets[grp.name]
        prof = grp.profile
        chips = max(len(grp.devices), 1)
        # memory: registered cache bytes vs the profile's HBM, λ-gated
        mem_frac = self.kv_bytes / max(chips * prof.memory_bytes, 1.0)
        mem_headroom = b.mem_lambda - mem_frac
        # power: battery envelope when budgeted, wall power otherwise
        if b.battery is not None:
            t_dnn = self._active_s[grp.name]
            pressure = float(offload_pressure(
                b.battery, t_dnn, 0.0, b.power_threshold_w))
            headroom = float(available_power(b.battery, t_dnn, 0.0)
                             ) - b.power_threshold_w
        else:
            pressure = 0.0
            headroom = chips * prof.power_budget_w
        busy = float(prof.busy_factor)
        if pressure >= b.pressure_hot:
            reason = "power"
        elif mem_headroom < 0.0:
            reason = "memory"
        elif busy > b.busy_max:
            reason = "busy"
        else:
            reason = ""
        return GroupAdmission(
            name=grp.name, hot=bool(reason), reason=reason,
            power_headroom_w=float(np.clip(headroom, -1e12, 1e12)),
            mem_headroom_frac=float(mem_headroom),
            pressure=pressure, busy_factor=busy)

    def assess(self) -> List[GroupAdmission]:
        return [self._assess_group(g) for g in self.groups]

    def fleet_hot(self) -> bool:
        """True when EVERY decode group is hot — re-routing has nowhere
        to go, so the ingress must shed instead of admitting blindly."""
        return all(a.hot for a in self.assess())
