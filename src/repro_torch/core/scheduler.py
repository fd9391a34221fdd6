"""HeteroEdge online task scheduler (paper §III, Algorithm 1).

Ties the pieces together per decision epoch:

  1. gather profiles (measured EMA or analytic)
  2. curve-fit T/E/M vs r                      (curvefit)
  3. gate: mobility latency L < β?             (mobility)
  4. gate: memory availability λ?              (Algorithm 1, line 3)
  5. battery pressure → r floor                (battery)
  6. solve Eq. 4 for r* (solve_star past 2 groups)   (solver)
  7. emit OffloadDecision (consumed by offload.OffloadEngine)

``SplitRatioController`` is the online feedback half of that loop for the
serving runtime: it folds measured per-group timings into EWMAs and
re-solves the split every N waves.  ``PrefillRouter`` prices shipping
shadow prefills to a dedicated prefill group (remote rate + the KV hop over
the edge's LinkModel) against local shadow prefill.  ``TenantScheduler``
is the ingress's weighted deficit round-robin.  All of it is host-side
control math: numpy and float32 CPU tensors, no device work.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import battery as batt_mod
from repro_torch.core import mobility as mob_mod
from repro_torch.core.curvefit import FittedModels, fit_profiles
from repro_torch.core.network import offload_latency
from repro_torch.core.offload import split_counts as _apportion
from repro_torch.core.profiler import MeasuredProfile
from repro_torch.core.solver import (SolverConstraints, SolverResult, objective,
                                     solve_split_ratio, solve_star)


@dataclass
class OffloadDecision:
    offload: bool
    split_ratio: float           # total offloaded fraction (1 − hub share)
    predicted_time: float
    reason: str
    solver: Optional[SolverResult] = None
    split: Optional[Any] = None  # SplitVector for star topologies


@dataclass
class SchedulerConfig:
    beta: float = 10.0                  # mobility latency threshold (s)
    lambda_mem: float = 0.95            # availability factor gate (Alg. 1 line 3)
    power_threshold_w: float = 8.0      # battery pressure threshold
    ema: float = 0.3                    # profile update smoothing
    reprobe_after: int = 2              # waves before the first down-state
                                        # re-probe of a dead group
    reprobe_max: int = 32               # re-probe backoff ceiling (waves)
    solver_constraints: SolverConstraints = field(
        default_factory=lambda: SolverConstraints(tau=1.0))


class Backoff:
    """Bounded exponential re-probe schedule on the wave clock.

    Shared by every recovery path that must rejoin a restored resource
    without polling it every wave: the :class:`PrefillRouter`'s latched-
    local auto re-probe and the
    :class:`~repro_torch.core.topology.HeteroRuntime` decode-group re-probe
    both run this exact state machine.  ``tick()``
    advances one wave and returns True on probe waves; a failed probe
    (``fail()``) doubles the wait up to ``maximum``; ``reset()`` re-arms
    after a successful revive.  Bound: a group restored at any point is
    re-probed within ``maximum`` waves of the restore.
    """

    def __init__(self, after: int = 2, maximum: int = 32):
        if after < 1:
            raise ValueError(f"backoff after must be >= 1, got {after}")
        if maximum < after:
            raise ValueError(f"backoff maximum {maximum} < after {after}")
        self.after = int(after)
        self.maximum = int(maximum)
        self.waves = 0               # waves since the last probe / reset
        self.next_probe = self.after

    @classmethod
    def from_config(cls, cfg: "SchedulerConfig") -> "Backoff":
        return cls(cfg.reprobe_after, cfg.reprobe_max)

    def reset(self) -> None:
        """Re-arm (resource revived, or freshly latched down)."""
        self.waves = 0
        self.next_probe = self.after

    def tick(self) -> bool:
        """Advance one wave; True iff this wave is a probe wave."""
        self.waves += 1
        return self.waves >= self.next_probe

    def fail(self) -> None:
        """The probe found the resource still down: double the wait."""
        self.waves = 0
        self.next_probe = min(self.next_probe * 2, self.maximum)


class TaskScheduler:
    def __init__(self, cfg: SchedulerConfig,
                 aux_prof: MeasuredProfile, pri_prof: MeasuredProfile,
                 off_prof: MeasuredProfile,
                 battery: Optional[batt_mod.BatteryState] = None,
                 mobility: Optional[mob_mod.MobilityModel] = None,
                 topology: Optional[Any] = None,
                 extra_spokes: Sequence[Tuple[MeasuredProfile,
                                              MeasuredProfile]] = ()):
        """``extra_spokes``: per additional spoke beyond (aux_prof,
        off_prof), its (exec, link-latency) profile pair — the scheduler
        then solves the §VIII star (``solve_star``) instead of Eq. 4.
        ``topology`` (optional) cross-checks the group count."""
        self.cfg = cfg
        self.aux_prof, self.pri_prof, self.off_prof = aux_prof, pri_prof, off_prof
        self.extra_spokes = list(extra_spokes)
        self.n_groups = 2 + len(self.extra_spokes)
        if topology is not None and len(topology) != self.n_groups:
            raise ValueError(
                f"topology has {len(topology)} groups but profiles cover "
                f"{self.n_groups} (aux + {len(self.extra_spokes)} extra)")
        self.topology = topology
        self.battery = battery
        self.mobility = mobility
        self.latency_curve = mob_mod.default_latency_curve()
        self.models: Optional[FittedModels] = None
        self.history = []

    # ------------------------------------------------------------------
    def refit(self) -> FittedModels:
        self.models = fit_profiles(self.aux_prof, self.pri_prof, self.off_prof)
        return self.models

    def observe(self, r: float, t_aux: float, t_pri: float, t_off: float,
                p_aux: float = 0.0, p_pri: float = 0.0,
                m_aux: float = 0.0, m_pri: float = 0.0):
        """EMA-update the nearest profile sample (paper: continuous logging)."""
        a = self.cfg.ema
        for prof, (t, p, m) in ((self.aux_prof, (t_aux, p_aux, m_aux)),
                                (self.pri_prof, (t_pri, p_pri, m_pri)),
                                (self.off_prof, (t_off, 0.0, 0.0))):
            best = min(prof.samples, key=lambda s: abs(s.r - r))
            if abs(best.r - r) > 0.05:
                prof.add(r, t, p, m)
            else:
                best.T = (1 - a) * best.T + a * t
                best.P = (1 - a) * best.P + a * p
                best.M = (1 - a) * best.M + a * m
        self.models = None  # force refit

    # ------------------------------------------------------------------
    def decide(self, *, elapsed_s: float = 0.0, t_dnn_s: float = 60.0,
               t_drive_s: float = 0.0) -> OffloadDecision:
        models = self.models or self.refit()
        cons = self.cfg.solver_constraints

        # mobility gate (Alg. 1 line 3: check latency L <= β)
        if self.mobility is not None:
            L = float(mob_mod.latency_at(self.latency_curve, self.mobility,
                                         elapsed_s))
            if L >= self.cfg.beta:
                dec = OffloadDecision(False, 0.0,
                                      float(objective(models, 0.0)),
                                      f"mobility: L={L:.2f}s >= beta={self.cfg.beta}s")
                self.history.append(dec)
                return dec
            cons = dataclasses.replace(cons, beta=self.cfg.beta)

        # memory availability gate (Alg. 1 line 3: M1, M2 >= λ)
        m_used_aux = models.M1(1.0)
        if float(m_used_aux) > 100.0 * self.cfg.lambda_mem:
            cons = dataclasses.replace(
                cons, m_max=(100.0 * self.cfg.lambda_mem, cons.m_max[1]))

        # battery pressure → offload floor (paper §V-A.4)
        if self.battery is not None:
            pressure = float(batt_mod.offload_pressure(
                self.battery, t_dnn_s, t_drive_s, self.cfg.power_threshold_w))
            cons = dataclasses.replace(cons, r_min=max(cons.r_min, 0.9 * pressure))

        if self.n_groups > 2:
            dec = self._decide_star(models, cons)
            self.history.append(dec)
            return dec

        res = solve_split_ratio(models, cons)
        if not res.feasible:
            # paper §VII-B: search failed within bounds -> process locally
            dec = OffloadDecision(False, 0.0, res.t_baseline,
                                  "infeasible: falling back to local", res)
        else:
            dec = OffloadDecision(res.r_opt > 1e-3, res.r_opt, res.t_opt,
                                  "solved", res)
        self.history.append(dec)
        return dec

    # ------------------------------------------------------------------
    def _decide_star(self, models: FittedModels,
                     cons: SolverConstraints) -> OffloadDecision:
        """§VIII star topology: solve per-group fractions over the simplex
        (makespan objective, ``solve_star``) instead of the scalar Eq. 4.
        The mobility gate has already run; the battery floor (r_min) is
        enforced on the TOTAL offloaded share by rescaling the spokes.
        The C1 deadline and the β link-latency gate are checked on the
        solved point like the pair path (infeasible → process locally,
        paper §VII-B); per-spoke energy/memory caps are not profiled yet
        (only T1/T3 fits exist per spoke — ROADMAP extension point)."""
        # lazy import: topology.py imports this module at top level
        from repro_torch.core.topology import SplitVector, group_times_from_fits

        spoke_fits = [(models.T1, models.T3)]
        for exec_prof, link_prof in self.extra_spokes:
            m = fit_profiles(exec_prof, self.pri_prof, link_prof)
            spoke_fits.append((m.T1, m.T3))
        fn = group_times_from_fits(models.T2, spoke_fits)
        f_opt, t_opt = solve_star(fn, self.n_groups)
        f = np.asarray(f_opt, np.float64)
        if cons.r_min > 0.0 and (1.0 - f[0]) < cons.r_min:
            # push work off the hub until the offload floor is met
            spokes = f[1:]
            spokes = spokes / spokes.sum() if spokes.sum() > 0 \
                else np.full(self.n_groups - 1, 1.0 / (self.n_groups - 1))
            f = np.concatenate([[1.0 - cons.r_min], cons.r_min * spokes])
            t_opt = float(np.max(np.asarray(fn(f))))
        # C1 deadline on the solved makespan; β on each spoke's link latency
        tau_eff = cons.deadline_slack * cons.tau / cons.k_devices
        beta_viol = any(float(T3(f[g])) > cons.beta
                        for g, (_, T3) in enumerate(spoke_fits, start=1))
        if float(t_opt) > tau_eff or beta_viol:
            t_local = float(models.T2(0.0))
            return OffloadDecision(
                False, 0.0, t_local,
                "star infeasible: falling back to local",
                split=SplitVector((1.0,) + (0.0,) * (self.n_groups - 1)))
        sv = SplitVector(tuple(f))
        return OffloadDecision(offload=sv.r > 1e-3, split_ratio=sv.r,
                               predicted_time=float(t_opt),
                               reason="solved-star", split=sv)


# ---------------------------------------------------------------------------
# Prefill-offload routing for disaggregated serving
# ---------------------------------------------------------------------------
@dataclass
class PrefillRoute:
    """One wave's prefill-placement decision with its priced costs."""
    remote: bool                 # ship shadow prefills to the prefill group
    t_local_s: float             # priced local shadow prefill, s/request
    t_remote_s: float            # priced remote prefill + KV hop, s/request
    reason: str


class PrefillRouter:
    """Prices prefill-offload vs. local shadow prefill from live timings.

    The decision rule is deliberately conservative and deterministic
    (property-tested against the reference):

    * no prefill group / group down  →  local, always;
    * nothing measured yet           →  remote (explore: the group can
      only be priced by sending it work), UNLESS the analytically priced
      KV-transfer hop alone already exceeds the measured local rate;
    * remote measured, local never   →  ONE local probe wave (a healthy
      session otherwise offloads every wave and the local side of the
      comparison would stay unmeasured forever);
    * both rates measured            →  remote iff
      ``remote_rate + hop_rate <= margin · local_rate``, with one local
      probe wave every ``probe_every`` consecutive remote waves so the
      local rate tracks load drift instead of freezing (the same
      never-go-fully-dark rationale as the split controller's
      exploration floor).

    Rates are EWMA-smoothed per shadow prefill; the hop uses the measured
    per-block transfer rate once one exists, else the LinkModel price for
    ``payload_bytes`` (set from the first observed block size).  A
    reported fallback (the worker died mid-wave) latches the router to
    local until ``revive()``.
    """

    def __init__(self, link=None, *, payload_bytes: float = 0.0,
                 distance: float = 1.0, ema: float = 0.3,
                 margin: float = 1.0, probe_every: int = 8,
                 reprobe_after: int = 2, reprobe_max: int = 32):
        self.link = link
        self.payload_bytes = float(payload_bytes)
        self.distance = float(distance)
        self.ema = float(ema)
        self.margin = float(margin)
        self.probe_every = int(probe_every)
        self.reprobe_after = int(reprobe_after)   # waves before the first
                                                  # down-state re-probe
        self.reprobe_max = int(reprobe_max)       # backoff ceiling (waves)
        self.rate_local: Optional[float] = None    # s per local shadow
        self.rate_remote: Optional[float] = None   # s per remote shadow
        self.rate_transfer: Optional[float] = None  # s per KV block hop
        # fraction of prefill work that SURVIVES the prefix cache (1.0 =
        # no cache / no hits).  Scales the analytic hop fallback: a
        # cached span never crosses the wire, so un-measured hops must
        # be priced on the residual tail, not the full block.  The
        # measured ``rate_transfer`` EWMA needs no scaling — it is built
        # from hops that were already compacted.
        self.prefix_residual = 1.0
        self.healthy = True
        # mobility latch (paper §V-A.5): set per wave by the runtime from
        # the edge's LinkTrace — while the fitted link latency is past β
        # the route is forced local regardless of the priced comparison,
        # and it re-opens the first wave the trace drops back below β.
        self.mobility_latched = False
        self._remote_streak = 0    # consecutive remote waves since the
                                   # local rate was last measured
        self._backoff = Backoff(self.reprobe_after, self.reprobe_max)
        self.history: List[PrefillRoute] = []

    # backoff internals, kept addressable under their historical names
    # (tests and dashboards read the probe clock directly)
    @property
    def _down_waves(self) -> int:
        return self._backoff.waves

    @_down_waves.setter
    def _down_waves(self, v: int) -> None:
        self._backoff.waves = int(v)

    @property
    def _next_probe(self) -> int:
        return self._backoff.next_probe

    @_next_probe.setter
    def _next_probe(self, v: int) -> None:
        self._backoff.next_probe = int(v)

    def _ewma(self, old: Optional[float], new: float) -> float:
        return new if old is None else (1 - self.ema) * old + self.ema * new

    def hop_price(self) -> float:
        """Priced KV-transfer hop per block: measured EWMA when one
        exists, else the LinkModel latency for ``payload_bytes``."""
        if self.rate_transfer is not None:
            return self.rate_transfer
        if self.link is None or self.payload_bytes <= 0.0:
            return 0.0
        return float(offload_latency(
            self.link, self.payload_bytes * self.prefix_residual,
            self.distance))

    def observe(self, *, local_s: float = 0.0, n_local: int = 0,
                remote_s: float = 0.0, n_remote: int = 0,
                transfer_s: float = 0.0, n_transfers: Optional[int] = None,
                payload_bytes: float = 0.0, fallbacks: int = 0,
                prefix_residual: Optional[float] = None) -> None:
        """Fold one wave's measured prefill timings into the EWMAs.

        ``local_s``/``remote_s`` are the wave's shadow-dispatch walls
        (``t_prefill_overlap_s``) and ``n_local``/``n_remote`` MUST count
        only the dispatches that wall covers (the engine times top-up
        shadows; inline boundary dispatches live in a different bucket) —
        mixing counts deflates one rate and biases the comparison.
        ``transfer_s`` is the wave's priced KV hops over ``n_transfers``
        transferred blocks (defaults to ``n_remote``; pass it when the
        wave also transferred inline-dispatched blocks).
        ``prefix_residual`` is the wave's surviving-prefill fraction
        (``1 − flops_avoided/flops_total``) — EWMA-folded so the hop
        fallback prices residual tails.  Any reported fallback marks the
        prefill group down."""
        if prefix_residual is not None:
            self.prefix_residual = self._ewma(
                None if self.prefix_residual == 1.0 else self.prefix_residual,
                max(0.0, min(1.0, float(prefix_residual))))
        if n_local > 0:
            self.rate_local = self._ewma(self.rate_local, local_s / n_local)
        if n_remote > 0:
            self.rate_remote = self._ewma(self.rate_remote,
                                          remote_s / n_remote)
        nt = n_remote if n_transfers is None else n_transfers
        if nt > 0:
            self.rate_transfer = self._ewma(self.rate_transfer,
                                            transfer_s / nt)
            if payload_bytes > 0.0:
                self.payload_bytes = payload_bytes / nt
        if fallbacks > 0:
            if self.healthy:
                # freshly latched: restart the re-probe backoff clock
                self._backoff.reset()
            self.healthy = False

    def revive(self) -> None:
        """Re-arm a latched-down router (the group came back)."""
        self.healthy = True
        self._backoff.reset()

    def maybe_revive(self, group_alive: bool) -> bool:
        """Bounded-backoff auto re-probe off the wave clock.

        ``revive()`` used to be operator-only, so a latched-local router
        stayed local forever after a transient prefill-group outage.
        Called once per wave (before ``route()``): while latched down,
        the shared :class:`Backoff` counts waves and probes the group's
        health every ``reprobe_after`` waves, doubling the wait after
        each failed probe up to ``reprobe_max``; the first probe that
        finds the group alive revives the router.  Returns True iff it
        revived this wave.
        """
        if self.healthy:
            return False
        if not self._backoff.tick():
            return False
        if group_alive:
            self.revive()
            return True
        self._backoff.fail()
        return False

    def route(self) -> PrefillRoute:
        """Decide this wave's prefill placement from the live prices."""
        hop = self.hop_price()
        if self.link is None:
            dec = PrefillRoute(False, self.rate_local or 0.0, float("inf"),
                               "no prefill group")
        elif not self.healthy:
            dec = PrefillRoute(False, self.rate_local or 0.0, float("inf"),
                               "prefill group down")
        elif self.mobility_latched:
            # β latch: the traced link latency priced the hop infeasible —
            # local this wave no matter what the EWMA comparison says
            dec = PrefillRoute(False, self.rate_local or 0.0, float("inf"),
                               "mobility: link latency past beta")
        elif self.rate_local is None:
            if self.rate_remote is None:
                # cold start: nothing measured at all — price the group
                dec = PrefillRoute(True, 0.0, hop,
                                   "explore: no remote rate yet")
            else:
                # remote is priced but local never ran: probe it once or
                # the comparison below would stay dead forever
                dec = PrefillRoute(False, 0.0,
                                   self.rate_remote + hop,
                                   "probe: no local rate yet")
        else:
            # unmeasured remote exec prices optimistically at 0 so the
            # hop alone can veto exploration
            t_remote = (self.rate_remote or 0.0) + hop
            if t_remote > self.margin * self.rate_local:
                dec = PrefillRoute(False, self.rate_local, t_remote,
                                   "kv-transfer hop prices out remote")
            elif self.probe_every > 0 \
                    and self._remote_streak >= self.probe_every:
                dec = PrefillRoute(False, self.rate_local, t_remote,
                                   "probe: refresh local rate")
            else:
                dec = PrefillRoute(True, self.rate_local, t_remote,
                                   "remote cheaper")
        self._remote_streak = self._remote_streak + 1 if dec.remote else 0
        self.history.append(dec)
        return dec


# ---------------------------------------------------------------------------
# Online split-ratio controller for the serving runtime
# ---------------------------------------------------------------------------
@dataclass
class ControllerConfig:
    update_every: int = 4        # re-solve Eq. 4 every N observed batches
    ema: float = 0.3             # smoothing on per-item execution rates
    r_init: float = 0.5
    r_min: float = 0.0
    r_max: float = 1.0
    deadline_slack: float = 4.0  # keep C1 loose: live timings drive r, not τ
    explore: float = 0.05        # never route a group fully dark: without a
                                 # trickle of work its EWMA rate freezes and
                                 # the controller can't see it recover


class SplitRatioController:
    """Closed-loop split-ratio tuning from live OffloadReport timings.

    Each ``observe(report)`` folds the report's measured per-item rates
    (local s/item, remote s/item, link s/item) into EWMAs; every
    ``update_every`` observations the controller synthesizes fresh
    (r, T, P, M) profiles from those rates, refits the Eq. 1-3 curves and
    re-solves Eq. 4.  ``r`` is the ratio the dispatcher should use next.
    """

    def __init__(self, cfg: Optional[ControllerConfig] = None,
                 constraints: Optional[SolverConstraints] = None,
                 n_groups: int = 2):
        """``n_groups`` > 2 switches the re-solve from Eq. 4 to the §VIII
        star (``solve_star`` over per-group fractions); the 2-group path is
        the scalar Eq. 4 controller."""
        self.cfg = cfg or ControllerConfig()
        self.constraints = constraints
        self.n_groups = int(n_groups)
        if self.n_groups < 2:
            raise ValueError("need at least hub + one spoke")
        self.rate_local: Optional[float] = None    # s per item, hub/primary
        self.rate_remote: Optional[float] = None   # s per item, auxiliary
        self.rate_link: Optional[float] = None     # s per item on the link
        # star state: per-spoke EWMA rates, spoke g at index g-1
        self._spoke_rates: List[Optional[float]] = [None] * (self.n_groups - 1)
        self._spoke_links: List[Optional[float]] = [None] * (self.n_groups - 1)
        self._r = self._clip(self.cfg.r_init)
        self._fractions = np.full(self.n_groups, 1.0 / self.n_groups)
        self._alive = np.ones(self.n_groups, bool)
        self._seen = 0
        self._batch = 0
        self.history: List[SolverResult] = []

    # --- fleet fault domain: surviving-simplex masking -----------------
    def set_alive(self, alive: Sequence[bool]) -> None:
        """Mask dead groups out of the simplex (hub-first order).  Every
        read of ``fractions`` / ``split_counts`` then projects the solved
        split onto the surviving groups: dead fractions exactly 0, the
        rest renormalized.  Raising on an all-dead mask keeps the failure
        loud — the runtime must stop serving, not divide by zero."""
        a = np.asarray(list(alive), bool)
        if a.shape != (self.n_groups,):
            raise ValueError(f"alive mask has {a.shape[0] if a.ndim else 0} "
                             f"entries for {self.n_groups} groups")
        if not a.any():
            raise ValueError("every group is masked dead — nothing can "
                             "take the wave")
        self._alive = a

    def _masked(self, f: np.ndarray) -> np.ndarray:
        """Project fractions onto the surviving simplex."""
        f = np.where(self._alive, np.maximum(np.asarray(f, np.float64), 0.0),
                     0.0)
        s = f.sum()
        if s <= 0.0:
            # every survivor solved to zero: split the wave evenly
            f = self._alive.astype(np.float64)
            s = f.sum()
        return f / s

    @property
    def r(self) -> float:
        """Total offloaded share (1 − hub fraction for star topologies)."""
        return float(1.0 - self.fractions[0])

    @property
    def fractions(self) -> np.ndarray:
        """Per-group SplitVector fractions, hub first — masked onto the
        surviving simplex when groups are dead."""
        base = (self._fractions.copy() if self.n_groups > 2
                else np.array([1.0 - self._r, self._r]))
        if self._alive.all():
            return base
        return self._masked(base)

    def _clip(self, r: float) -> float:
        """Solver output clipped to [r_min, r_max], then held away from the
        0/1 extremes by the exploration margin so both groups keep seeing
        (and timing) real work."""
        e = self.cfg.explore
        lo = max(self.cfg.r_min, e)
        hi = min(self.cfg.r_max, 1.0 - e)
        return float(np.clip(r, lo, max(lo, hi)))

    def split(self, n: int) -> int:
        """Number of items (of n) to offload at the current ratio — at least
        one per group when exploration is on and n allows it."""
        n_off = int(round(self._r * n))
        if self.cfg.explore > 0.0 and n >= 2:
            n_off = min(max(n_off, 1), n - 1)
        return n_off

    def split_counts(self, n: int) -> Tuple[int, ...]:
        """Per-group item counts (hub first) at the current split.  The
        all-healthy pair case routes through :meth:`split`; star (and any
        masked topology) uses largest-remainder apportionment with the
        exploration floor — every SURVIVING group
        keeps at least one item when n allows, so no live group's EWMA
        rate ever goes dark, while dead groups get exactly zero."""
        if self.n_groups == 2 and self._alive.all():
            n_off = self.split(n)
            return (n - n_off, n_off)
        fr = (self.fractions if not self._alive.all()
              else self._fractions)
        counts = list(_apportion(tuple(fr), n))
        live = [g for g in range(self.n_groups) if self._alive[g]]
        if self.cfg.explore > 0.0 and n >= len(live):
            for g in live:
                while counts[g] == 0:
                    donor = int(np.argmax(counts))
                    counts[donor] -= 1
                    counts[g] += 1
        return tuple(counts)

    def _ema(self, old: Optional[float], new: float) -> float:
        a = self.cfg.ema
        return new if old is None else (1 - a) * old + a * new

    def observe(self, report) -> float:
        """Fold one measured batch into the EWMAs; returns the (possibly
        re-solved) split ratio to use for the next batch.  Star controllers
        consume the widened per-group report fields."""
        if self.n_groups > 2:
            return self._observe_star(report)
        if report.n_local:
            self.rate_local = self._ema(self.rate_local,
                                        report.t_local_s / report.n_local)
        if report.n_offloaded:
            self.rate_remote = self._ema(self.rate_remote,
                                         report.t_remote_s / report.n_offloaded)
            self.rate_link = self._ema(self.rate_link,
                                       report.t_offload_s / report.n_offloaded)
        self._batch = max(self._batch, report.n_local + report.n_offloaded)
        self._seen += 1
        if self._seen % self.cfg.update_every == 0 and \
                self.rate_local is not None and self.rate_remote is not None:
            self._resolve()
        return self._r

    def _resolve(self):
        B = max(self._batch, 1)
        loc, rem = self.rate_local, self.rate_remote
        link = self.rate_link or 0.0
        aux = MeasuredProfile("aux-live")
        pri = MeasuredProfile("pri-live")
        off = MeasuredProfile("off-live")
        for r in (0.0, 0.25, 0.5, 0.75, 1.0):
            aux.add(r, rem * r * B, 1.0, 50.0 * r)
            pri.add(r, loc * (1 - r) * B, 1.0, 50.0 * (1 - r))
            off.add(r, link * r * B, 0.0, 0.0)
        cons = self.constraints or SolverConstraints(
            tau=loc * B, k_devices=1,
            deadline_slack=self.cfg.deadline_slack)
        cons = dataclasses.replace(cons, r_min=max(cons.r_min, self.cfg.r_min))
        res = solve_split_ratio(fit_profiles(aux, pri, off), cons)
        self.history.append(res)
        if res.feasible:
            self._r = self._clip(res.r_opt)

    # --- star topology (n_groups > 2) ---------------------------------
    def _observe_star(self, report) -> float:
        """Fold a widened OffloadReport (per-group timings, hub first)
        into per-spoke EWMAs; re-solve the star every ``update_every``."""
        if not report.t_group_s or len(report.n_group) != self.n_groups:
            raise ValueError(
                f"star controller needs per-group report fields for "
                f"{self.n_groups} groups, got {len(report.n_group)}")
        if report.n_group[0]:
            self.rate_local = self._ema(
                self.rate_local, report.t_group_s[0] / report.n_group[0])
        for g in range(1, self.n_groups):
            if report.n_group[g]:
                self._spoke_rates[g - 1] = self._ema(
                    self._spoke_rates[g - 1],
                    report.t_group_s[g] / report.n_group[g])
                self._spoke_links[g - 1] = self._ema(
                    self._spoke_links[g - 1],
                    report.t_link_s[g] / report.n_group[g])
        self._batch = max(self._batch, sum(report.n_group))
        self._seen += 1
        if self._seen % self.cfg.update_every == 0 and \
                self.rate_local is not None and \
                all(r is not None for r in self._spoke_rates):
            self._resolve_star()
        return self.r

    def _resolve_star(self):
        """Re-solve per-group fractions from the live EWMA rates.  With
        linear per-item costs the star makespan objective and Eq. 4
        coincide at the optimum (the solver tests check it), so this IS the
        paper's solve, generalized."""
        B = max(self._batch, 1)
        loc = self.rate_local
        spoke_cost = np.array(
            [self._spoke_rates[g] + (self._spoke_links[g] or 0.0)
             for g in range(self.n_groups - 1)])
        costs = torch.tensor(np.concatenate([[loc], spoke_cost]) * B,
                             dtype=torch.float32)

        def group_time_fn(f):
            return f * costs

        f_opt, t_opt = solve_star(group_time_fn, self.n_groups)
        f = np.asarray(f_opt, np.float64)
        # exploration floor: no group goes fully dark (same rationale as
        # the pair controller's explore margin)
        e = self.cfg.explore
        if e > 0.0:
            f = np.maximum(f, e / max(self.n_groups - 1, 1))
            f = f / f.sum()
        if not self._alive.all():
            # re-solve lands on the surviving simplex: dead groups carry
            # stale EWMA rates, so their share is forced to exactly zero
            f = self._masked(f)
        self._fractions = f
        t_base = float(loc * B)
        self.history.append(SolverResult(
            r_opt=float(1.0 - f[0]), t_opt=float(t_opt), feasible=True,
            t_baseline=t_base,
            improvement=1.0 - float(t_opt) / max(t_base, 1e-9),
            diagnostics={"fractions": f.tolist()}))


# ---------------------------------------------------------------------------
# Multi-tenant ingress fairness
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TenantClass:
    """One tenant's deadline/priority class at the serving ingress.

    ``TaskScheduler.decide`` gates a single UGV's work on deadline
    feasibility (mobility latency < β); the ingress generalizes that to
    many tenants sharing one fleet: ``priority`` ranks the deadline
    class (0 = tightest TTFT deadline — preempts the admission queue),
    ``weight`` sets the tenant's long-run fair share, and ``deadline_s``
    is the class's TTFT target (telemetry-facing: the SLO bench gates
    p99 TTFT against it)."""
    name: str
    priority: int = 1
    weight: float = 1.0
    deadline_s: float = float("inf")

    def __post_init__(self):
        if self.weight <= 0.0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.priority < 0:
            raise ValueError(f"tenant {self.name!r}: priority must be >= 0")


class TenantScheduler:
    """Weighted deficit round-robin across tenants, with deadline-class
    preemption of the admission queue.

    Classic DRR, cost 1 per request: each round every *backlogged*
    tenant earns ``weight · quantum`` of deficit — whether or not the
    round reaches it — and drains whole requests while its deficit
    covers them; a tenant's deficit resets when its queue empties (no
    banked credit bursts).  Draining rotates: each round resumes at the
    tenant where the previous wave filled up, so a tenant that fills
    every wave cannot pin the visit order on itself.  The selected wave
    is emitted urgent-class first, so a tight-deadline tenant preempts
    the dispatch *order* every wave — but never the deficit
    *accounting*, which is what makes starvation impossible: a
    backlogged tenant's deficit grows every round until the rotation
    reaches it with credit to spend, no matter how adversarial the
    arrival schedule (property-tested).

    Deterministic and host-side only — no clocks, no PRNG — so the
    derandomized hypothesis suite can pin its behavior exactly."""

    def __init__(self, tenants: Dict[str, TenantClass],
                 quantum: float = 1.0):
        if not tenants:
            raise ValueError("at least one TenantClass is required")
        self.tenants = dict(tenants)
        self.quantum = float(quantum)
        self._order = sorted(self.tenants,
                             key=lambda t: (self.tenants[t].priority, t))
        self._queues: Dict[str, deque] = {t: deque() for t in self._order}
        self._deficit: Dict[str, float] = {t: 0.0 for t in self._order}
        self._rot = 0     # rotating drain pointer into _order

    def enqueue(self, tenant: str, item: Any) -> int:
        """FIFO within a tenant; returns the tenant's queue depth after
        the push (the frontend's backpressure signal)."""
        if tenant not in self._queues:
            raise KeyError(f"unknown tenant {tenant!r} "
                           f"(have {sorted(self._queues)})")
        self._queues[tenant].append(item)
        return len(self._queues[tenant])

    def backlog(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return len(self._queues[tenant])
        return sum(len(q) for q in self._queues.values())

    def select(self, n: int) -> List[Tuple[str, Any]]:
        """Pop up to ``n`` requests for the next wave.  Always returns
        ``min(n, backlog)`` items — DRR rounds repeat until the wave is
        full, so a full fleet never idles on deficit bookkeeping."""
        picked: List[Tuple[str, Any]] = []
        order, T = self._order, len(self._order)
        while len(picked) < n and self.backlog():
            # credit EVERY backlogged tenant up front: a wave that fills
            # early must not stop the others' deficit clocks
            for t in order:
                if self._queues[t]:
                    self._deficit[t] += self.tenants[t].weight * self.quantum
            start = self._rot
            for k in range(T):
                t = order[(start + k) % T]
                q = self._queues[t]
                if not q:
                    continue
                while q and self._deficit[t] >= 1.0 and len(picked) < n:
                    picked.append((t, q.popleft()))
                    self._deficit[t] -= 1.0
                if not q:
                    self._deficit[t] = 0.0
                if len(picked) >= n:
                    # always resume PAST the tenant that filled the wave
                    # — banked deficit keeps its claim, but the filler
                    # never pins the rotation on itself
                    self._rot = (start + k + 1) % T
                    break
        # deadline-class preemption: the wave DISPATCH order is
        # urgent-class first (stable within a class — FIFO preserved)
        picked.sort(key=lambda p: self.tenants[p[0]].priority)
        return picked
