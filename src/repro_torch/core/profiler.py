"""HeteroEdge device profiles (paper §IV).

A *node group* is one or more devices of this host (here: CUDA cards), or
a synthetic device described by the paper's own published tables
(:class:`MeasuredProfile`, Table I / III).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

# --- NVIDIA H100 SXM constants (per card; NVIDIA data sheet, dense rates) --
H100_PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores
H100_HBM_BW = 3.35e12              # B/s
H100_NVLINK_BW = 450e9             # B/s each way to the other cards
H100_TDP_W = 700.0                 # board power limit at full rate
H100_HBM_BYTES = 80e9              # 80 GB


@dataclass(frozen=True)
class DeviceProfile:
    """Capability description of one node group (paper: one Jetson)."""
    name: str
    chips: int = 1
    peak_flops: float = H100_PEAK_FLOPS_BF16   # per chip
    hbm_bw: float = H100_HBM_BW
    link_bw: float = H100_NVLINK_BW
    busy_factor: float = 0.0              # fraction of compute consumed by background load
    power_budget_w: float = H100_TDP_W    # per chip (current allowance)
    nominal_power_w: Optional[float] = None  # per chip TDP; default = budget
    memory_bytes: float = H100_HBM_BYTES  # per chip
    mu: Optional[float] = None            # cubic power-model coefficient P = µ·S³;
                                          # default µ = P_max / S_max³ (paper §V-A.1)

    @property
    def mu_eff(self) -> float:
        return self.mu if self.mu is not None \
            else self.power_budget_w / self.peak_flops ** 3

    @property
    def effective_flops(self) -> float:
        return self.chips * self.peak_flops * (1.0 - self.busy_factor)

    @property
    def dvfs_scale(self) -> float:
        """Cube-root DVFS law: capping power below the nominal TDP caps the
        clock to (P/TDP)^⅓ (inverse of the paper's P = µ·S³)."""
        nominal = self.nominal_power_w or self.power_budget_w
        return min(1.0, (self.power_budget_w / nominal) ** (1.0 / 3.0))

    def exec_time(self, flops: float, hbm_bytes: float = 0.0) -> float:
        """Roofline execution-time estimate for this group."""
        derate = (1.0 - self.busy_factor) * self.dvfs_scale
        t_c = flops / max(self.chips * self.peak_flops * derate, 1.0)
        t_m = hbm_bytes / max(self.chips * self.hbm_bw * derate, 1.0)
        return max(t_c, t_m)

    def power(self, utilization: float = 1.0) -> float:
        """Cubic DVFS power model, P = µ·S³ scaled to the utilized speed."""
        s = utilization * (1.0 - self.busy_factor)
        return self.chips * self.mu_eff * (s * self.peak_flops) ** 3

    def energy(self, flops: float, hbm_bytes: float = 0.0) -> float:
        return self.power(1.0) * self.exec_time(flops, hbm_bytes)


# Paper testbed stand-ins (Jetson Nano ~472 GFLOPS fp16, Xavier ~1.4e12
# effective in the paper's fp16 workloads).
JETSON_NANO = DeviceProfile(
    name="jetson-nano", chips=1, peak_flops=4.72e11, hbm_bw=25.6e9,
    link_bw=5e6, power_budget_w=10.0, memory_bytes=4 * 1024**3, mu=10.0 / (4.72e11) ** 3)
JETSON_XAVIER = DeviceProfile(
    name="jetson-xavier", chips=1, peak_flops=1.41e12, hbm_bw=136e9,
    link_bw=5e6, power_budget_w=30.0, memory_bytes=8 * 1024**3, mu=30.0 / (1.41e12) ** 3)


# ---------------------------------------------------------------------------
@dataclass
class ProfileSample:
    r: float          # split ratio
    T: float          # execution time (s)
    P: float          # power (W)
    M: float          # memory utilization (fraction or %)


@dataclass
class MeasuredProfile:
    """A set of (r, T, P, M) samples for one node, paper Table I style."""
    device: str
    samples: List[ProfileSample] = field(default_factory=list)

    def add(self, r, T, P, M):
        self.samples.append(ProfileSample(r, T, P, M))
        return self

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        s = sorted(self.samples, key=lambda x: x.r)
        return (np.array([x.r for x in s]), np.array([x.T for x in s]),
                np.array([x.P for x in s]), np.array([x.M for x in s]))


# --- The paper's own measurements (Table I): 100-image multi-DNN batch ----
# columns: r, T1(Xavier,s), P1(W), M1(%), T2(Nano,s), T3(off-lat,s), P2, M2
PAPER_TABLE_I = [
    (0.0, 0.0,    0.95, 10.2,  68.34, 0.0,  5.89, 69.82),
    (0.3, 8.45,   4.59, 36.67, 39.03, 0.43, 5.35, 63.77),
    (0.5, 13.88,  5.42, 45.61, 28.35, 0.89, 5.63, 52.54),
    (0.7, 16.64,  5.73, 51.23, 19.54, 1.25, 4.75, 45.58),
    (0.8, 17.24,  6.17, 56.96, 13.34, 1.44, 4.48, 40.34),
    (1.0, 19.001, 6.38, 59.37, 0.0,   1.56, 0.77, 16.0),
]

# Table III: real-time static-condition system (4 m separation)
PAPER_TABLE_III = [
    # r,  T3,   P1,   M1,    T1+T2, P2,   M2
    (0.2,  0.67, 4.87, 32.09, 55.38, 6.96, 75.12),
    (0.35, 1.23, 5.12, 41.56, 51.89, 6.11, 70.17),
    (0.45, 1.98, 5.78, 49.55, 42.87, 6.24, 65.66),
    (0.5,  2.34, 5.57, 50.09, 43.09, 5.69, 54.65),
    (0.6,  2.90, 6.35, 53.0,  39.45, 5.88, 57.77),
    (0.7,  3.23, 6.03, 59.56, 36.43, 5.17, 47.13),
    (0.8,  3.55, 6.34, 63.45, 34.90, 5.35, 43.34),
    (0.9,  3.56, 7.12, 69.09, 28.23, 4.89, 40.11),
]


def paper_profiles() -> Tuple[MeasuredProfile, MeasuredProfile, MeasuredProfile]:
    """(auxiliary=Xavier, primary=Nano, offload-latency) from Table I."""
    aux = MeasuredProfile("jetson-xavier")
    pri = MeasuredProfile("jetson-nano")
    off = MeasuredProfile("offload-latency")
    for r, t1, p1, m1, t2, t3, p2, m2 in PAPER_TABLE_I:
        aux.add(r, t1, p1, m1)
        pri.add(r, t2, p2, m2)
        off.add(r, t3, 0.0, 0.0)
    return aux, pri, off


# ---------------------------------------------------------------------------
@dataclass
class WorkloadCost:
    """Per-request cost of one workload unit (from a program's cost
    profile: ``serving/profiling.py``)."""
    name: str
    flops: float
    hbm_bytes: float
    collective_bytes: float = 0.0
    request_bytes: float = 0.0     # bytes that cross the link if offloaded

    def scaled(self, fraction: float) -> "WorkloadCost":
        return WorkloadCost(self.name, self.flops * fraction,
                            self.hbm_bytes * fraction,
                            self.collective_bytes * fraction,
                            self.request_bytes * fraction)


def analytic_profile(device: DeviceProfile, cost: WorkloadCost,
                     rs: Sequence[float]) -> MeasuredProfile:
    """Synthesize a MeasuredProfile for `device` executing fraction r of the
    workload per sample -- the analytic substitute for Table I."""
    prof = MeasuredProfile(device.name)
    for r in rs:
        c = cost.scaled(r)
        t = device.exec_time(c.flops, c.hbm_bytes)
        p = device.power(min(1.0, r + 0.05))
        m = min(1.0, (c.hbm_bytes / max(device.chips * device.memory_bytes, 1.0)))
        prof.add(r, t, p, m)
    return prof
