"""HeteroEdge split-ratio solver (paper §V, Eq. 4), in float32.

    min_r  T(r) = r·(T1(r) + T3(r)) + (1−r)·T2(r)
    s.t.   C1: T ≤ τ/k          C2: 0 ≤ P_k ≤ P^max
           C3: 0 < r < 1        C4: 0 ≤ S ≤ S^max
           C5: E_exe ≤ W^k      C6: M_exe ≤ M^k
           (+ mobility gate L < β, + battery pressure floor)

The paper uses GEKKO+IPOPT; like the JAX package this is an exact dense
scan over the (1-D, smooth, low-order-polynomial) objective with an
exterior penalty for the constraints, then golden-section refinement in
the best bracket: the same 1025-point grid and 60 iterations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import torch

from repro_torch.core.curvefit import FittedModels

_F32 = torch.float32


@dataclass(frozen=True)
class SolverConstraints:
    tau: float                       # single-device baseline time (C1 numerator)
    k_devices: int = 2
    p_max: Tuple[float, float] = (30.0, 15.0)    # (aux, pri) power caps, W
    w_max: Tuple[float, float] = (1e9, 1e9)      # (aux, pri) energy budgets, J
    m_max: Tuple[float, float] = (100.0, 100.0)  # memory caps (same units as fits)
    beta: float = float("inf")       # mobility latency threshold (s)
    r_min: float = 0.0               # battery-pressure floor on r
    deadline_slack: float = 1.0      # multiplies τ/k (1.0 = paper's C1)


@dataclass
class SolverResult:
    r_opt: float
    t_opt: float
    feasible: bool
    t_baseline: float                # T at r=0 (all local)
    improvement: float               # 1 - t_opt / t_baseline
    diagnostics: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
def objective(models: FittedModels, r) -> torch.Tensor:
    """Paper objective: T = r(T1 + T3) + (1-r)T2."""
    r = torch.as_tensor(r, dtype=_F32)
    return r * (models.T1(r) + models.T3(r)) + (1.0 - r) * models.T2(r)


def _violations(models: FittedModels, r, tau_eff, w_max, m_max, beta, r_min):
    T = objective(models, r)
    zero = torch.zeros((), dtype=_F32)
    v = [torch.maximum(T - tau_eff, zero),                 # C1 deadline
         torch.maximum(models.E1(r) - w_max[0], zero),     # C5 energy budgets
         torch.maximum(models.E2(r) - w_max[1], zero),
         torch.maximum(models.M1(r) - m_max[0], zero),     # C6 memory caps
         torch.maximum(models.M2(r) - m_max[1], zero),
         torch.maximum(models.T3(r) - beta, zero),         # mobility gate
         torch.maximum(r_min - r, zero)]                   # battery floor
    return torch.stack(v)


def constraint_violations(models: FittedModels, cons: SolverConstraints, r):
    """Non-negative violation magnitudes for C1, C5, C6 and the mobility
    and battery gates.  Zero ⇔ feasible."""
    r = torch.as_tensor(r, dtype=_F32)
    f = lambda x: torch.tensor(x, dtype=_F32)   # noqa: E731
    return _violations(models, r,
                       f(cons.deadline_slack * cons.tau / cons.k_devices),
                       (f(cons.w_max[0]), f(cons.w_max[1])),
                       (f(cons.m_max[0]), f(cons.m_max[1])),
                       f(cons.beta), f(cons.r_min))


def _golden_section(f, lo, hi, iters: int = 60):
    gr = torch.tensor((math.sqrt(5.0) - 1.0) / 2.0, dtype=_F32)
    a, b = lo, hi
    for _ in range(iters):
        c = b - gr * (b - a)
        d = a + gr * (b - a)
        keep_left = f(c) < f(d)
        a, b = torch.where(keep_left, a, c), torch.where(keep_left, d, b)
    return (a + b) / 2.0


def solve_split_ratio(models: FittedModels, cons: SolverConstraints) -> SolverResult:
    """Solve Eq. 4 for the optimal split ratio."""
    vec = torch.tensor([cons.deadline_slack * cons.tau / cons.k_devices,
                        cons.w_max[0], cons.w_max[1],
                        cons.m_max[0], cons.m_max[1],
                        min(cons.beta, 1e30), cons.r_min], dtype=_F32)
    tau_eff, w1, w2, m1, m2, beta, r_min = vec

    def viol(r):
        # grid values carry a trailing axis; stack puts constraints first
        return _violations(models, r, tau_eff, (w1, w2), (m1, m2), beta, r_min)

    def f(r):
        v = viol(r)
        # exterior quadratic penalty, scaled to the objective magnitude
        return objective(models, r) + 1e4 * torch.sum(v ** 2, dim=0) \
            + 1e2 * torch.sum((v > 0).to(_F32), dim=0)

    rs = torch.linspace(0.0, 1.0, 1025, dtype=_F32)
    vals = f(rs)
    i = int(torch.argmin(vals))
    zero, one = torch.zeros((), dtype=_F32), torch.ones((), dtype=_F32)
    lo = torch.clamp(rs[i] - 1e-2, zero, one)
    hi = torch.clamp(rs[i] + 1e-2, zero, one)
    r_opt = _golden_section(f, lo, hi)
    # pick the better of grid best / refined (golden can drift on plateaus)
    r_opt = torch.where(f(r_opt) <= vals[i], r_opt, rs[i])
    t_opt = objective(models, r_opt)
    v = viol(r_opt)
    t_base = float(objective(models, 0.0))
    return SolverResult(
        r_opt=float(r_opt), t_opt=float(t_opt),
        feasible=bool(torch.all(v <= 1e-6)), t_baseline=t_base,
        improvement=1.0 - float(t_opt) / max(t_base, 1e-9),
        diagnostics={"violations": v.tolist()})
