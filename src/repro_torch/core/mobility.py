"""Mobility constraints (paper §V-A.5, §VII-B Case-2), in float32.

Distance model:      d(t) = (V_primary + V_auxiliary) · t
Fitted latency:      L(d) = a1·d² − a2·d + a3
Threshold control:   if L ≥ β → stop offloading (re-solve with smaller r,
                     fall back to local execution if no feasible r).

:class:`LinkTrace` closes the loop between this model and the serving
runtime: a per-edge trace of distance (and optionally bandwidth) samples is
replayed on the wave clock, updating the edge's
:class:`~repro_torch.core.network.LinkModel` every wave; the β latch forces
that edge local while the fitted latency prices it out and re-opens it when
the trace drops back below β.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.curvefit import PolyFit, polyfit
from repro_torch.core.network import with_bandwidth


@dataclass(frozen=True)
class MobilityModel:
    v_primary: float = 1.0       # m/s (paper Case-2)
    v_auxiliary: float = 3.0     # m/s
    beta: float = 10.0           # latency threshold β (s)


def distance(mob: MobilityModel, t_s) -> torch.Tensor:
    return (mob.v_primary + mob.v_auxiliary) \
        * torch.as_tensor(t_s, dtype=torch.float32)


# Fitted on the paper's Fig-6-style measurements: latency rises superlinearly
# with distance; anchored at (4 m, ~1.25 s) and (26 m, ~13.9 s).
def default_latency_curve() -> PolyFit:
    d = np.array([2.0, 4.0, 6.0, 10.0, 14.0, 18.0, 22.0, 26.0])
    lat = np.array([0.9, 1.25, 1.9, 3.4, 5.5, 8.0, 10.8, 13.9])
    return polyfit(d, lat, 2)


def latency_at(curve: PolyFit, mob: MobilityModel, t_s) -> torch.Tensor:
    return curve(distance(mob, t_s))


def should_offload(curve: PolyFit, mob: MobilityModel, t_s) -> torch.Tensor:
    """paper: If L ≥ β, stop sending data."""
    return latency_at(curve, mob, t_s) < mob.beta


# ---------------------------------------------------------------------------
@dataclass
class LinkTrace:
    """Mobility-driven churn for ONE topology edge, replayed per wave.

    ``distances`` are meters sampled on the serve wave clock (held at the
    last sample once the trace runs out); with no samples the default drift
    ``d(t) = (V_primary + V_auxiliary)·t`` applies at ``wave_dt_s`` seconds
    per wave.  ``bandwidths`` optionally sets the live bandwidth per wave;
    otherwise radio links follow the traced distance through their
    path-loss term and interconnect links are derated by the fitted
    latency's ratio to the trace start.  The latency curve defaults to
    :func:`default_latency_curve` and β to :class:`MobilityModel`'s: the
    paper's §V-A.5 stop condition, evaluated per wave by :meth:`feasible`.
    """
    distances: Tuple[float, ...] = ()
    bandwidths: Tuple[float, ...] = ()   # explicit bandwidth_hz per wave
    curve: Optional[PolyFit] = None
    mob: MobilityModel = field(default_factory=MobilityModel)
    wave_dt_s: float = 1.0               # wave clock → seconds for the drift

    def __post_init__(self):
        if self.curve is None:
            self.curve = default_latency_curve()
        self.distances = tuple(float(d) for d in self.distances)
        self.bandwidths = tuple(float(b) for b in self.bandwidths)

    @staticmethod
    def _sample(seq: Tuple[float, ...], wave: int) -> float:
        return seq[min(int(wave), len(seq) - 1)]

    def distance_at(self, wave: int) -> float:
        if self.distances:
            return self._sample(self.distances, wave)
        return float(distance(self.mob, wave * self.wave_dt_s))

    def latency_at(self, wave: int) -> float:
        """Fitted link latency L(d) at this wave's traced distance."""
        return float(self.curve(self.distance_at(wave)))

    def feasible(self, wave: int) -> bool:
        """β latch (paper §V-A.5): offload only while L(d) < β."""
        return self.latency_at(wave) < self.mob.beta

    def bandwidth_at(self, link, wave: int) -> float:
        """The edge's live bandwidth_hz this wave."""
        if self.bandwidths:
            return self._sample(self.bandwidths, wave)
        if not link.is_ici:
            # radio: distance enters the Shannon–Hartley rate through the
            # path-loss term; the nominal channel width is unchanged
            return float(link.bandwidth_hz)
        l0 = max(float(self.curve(self.distance_at(0))), 1e-9)
        return float(link.bandwidth_hz
                     * min(1.0, l0 / max(self.latency_at(wave), 1e-9)))

    def link_at(self, link, wave: int):
        """``link`` updated to this wave's traced bandwidth."""
        bw = self.bandwidth_at(link, wave)
        if bw == link.bandwidth_hz:
            return link
        return with_bandwidth(link, bw)

    @classmethod
    def from_spec(cls, spec: str, *,
                  beta: Optional[float] = None) -> "LinkTrace":
        """Parse a ``--link-trace`` spec: comma-separated distances in
        meters (``"4,12,28,12,4"``), or ``@path`` to a JSON file with
        optional ``distances`` / ``bandwidths`` arrays.  ``beta`` overrides
        the MobilityModel latency threshold."""
        mob = MobilityModel() if beta is None else MobilityModel(beta=beta)
        if spec.startswith("@"):
            with open(spec[1:]) as fh:
                payload = json.load(fh)
            return cls(distances=tuple(payload.get("distances", ())),
                       bandwidths=tuple(payload.get("bandwidths", ())),
                       mob=mob)
        ds = tuple(float(x) for x in spec.split(",") if x.strip())
        if not ds:
            raise ValueError(f"empty --link-trace spec {spec!r}")
        return cls(distances=ds, mob=mob)
