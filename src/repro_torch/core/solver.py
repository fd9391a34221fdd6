"""HeteroEdge split-ratio solver (paper §V, Eq. 4), in float32.

    min_r  T(r) = r·(T1(r) + T3(r)) + (1−r)·T2(r)
    s.t.   C1: T ≤ τ/k          C2: 0 ≤ P_k ≤ P^max
           C3: 0 < r < 1        C4: 0 ≤ S ≤ S^max
           C5: E_exe ≤ W^k      C6: M_exe ≤ M^k
           (+ mobility gate L < β, + battery pressure floor)

The paper uses GEKKO+IPOPT; like the JAX package this is an exact dense
scan over the (1-D, smooth, low-order-polynomial) objective with an
exterior penalty for the constraints, then golden-section refinement in
the best bracket: the same 1025-point grid and 60 iterations.  For the
star topology (paper §VIII future work) ``solve_star`` descends on the
simplex of per-group fractions with ``torch.autograd``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Tuple

import numpy as np
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


def penalized(models: FittedModels, cons: SolverConstraints, r,
              penalty: float = 1e4) -> torch.Tensor:
    """Objective plus an exterior penalty and a feasibility bias."""
    v = constraint_violations(models, cons, r)
    return objective(models, r) + penalty * torch.sum(v ** 2) \
        + penalty * torch.sum(v > 0)


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


# ---------------------------------------------------------------------------
# Compression-aware joint solve: co-optimize the split ratio r AND the
# masking keep-rate k (the paper treats them separately).
# ---------------------------------------------------------------------------
def solve_joint(models: FittedModels, cons: SolverConstraints, *,
                accuracy_per_drop: float = 0.08, max_accuracy_loss: float = 0.02,
                compute_scaling: float = 0.45) -> Tuple[float, float, float]:
    """min_{r,k}  T(r,k) = r·(T1(r)·s(k) + T3(r)·k) + (1−r)·T2(r)·s(k)

    where k ∈ (0,1] is the token keep-rate, s(k) = 1 − compute_scaling·(1−k)
    is the §VI downstream-compute scaling, offload bytes scale ∝ k, and an
    accuracy constraint bounds (1−k): paper §VI measured ~2 % accuracy loss
    at ~28 % bandwidth saving, i.e. accuracy_per_drop ≈ 0.07.

    Returns (r_opt, k_opt, t_opt) from a dense 257 x 65 scan (the surface
    is smooth and low-order)."""
    k_min = max(1e-3, 1.0 - max_accuracy_loss / max(accuracy_per_drop, 1e-9))
    rs = torch.linspace(0.0, 1.0, 257, dtype=_F32)
    ks = torch.linspace(k_min, 1.0, 65, dtype=_F32)
    r, k = rs[:, None], ks[None, :]
    s = 1.0 - compute_scaling * (1.0 - k)
    T = r * (models.T1(r) * s + models.T3(r) * k) + (1.0 - r) * models.T2(r) * s
    v = constraint_violations(models, cons, rs)           # [7, 257]
    grid = T + 1e4 * torch.sum(v ** 2, dim=0)[:, None]
    i = int(torch.argmin(grid))
    return (float(rs[i // ks.shape[0]]), float(ks[i % ks.shape[0]]),
            float(grid.reshape(-1)[i]))


# ---------------------------------------------------------------------------
# Star topology (paper §VIII future work): one hub, G spokes.
# ---------------------------------------------------------------------------
def solve_star(group_time_fn: Callable[[torch.Tensor], torch.Tensor],
               n_groups: int, *, iters: int = 800,
               lr: float = 0.1) -> Tuple[np.ndarray, float]:
    """Minimize the parallel completion time  max_g T_g(f)  over the simplex
    f ≥ 0, Σf = 1 (one fraction per group, hub first).

    ``group_time_fn``: f [G] float32 tensor -> per-group total times [G]
    (exec + offload), differentiable in torch.  A softmax parametrization
    and an annealed smooth max (temperature ``max(0.5·0.995^i, 1e-3)``,
    logsumexp) give a gradient at every step; ``iters`` steps of plain
    descent at ``lr`` run on the host in float32.

    The objective is normalized by its value at the uniform split first:
    raw gradients scale with the workload's absolute seconds, and on
    paper-magnitude profiles (tens of seconds) an unnormalized lr=0.1 step
    saturates the softmax in one iteration."""
    with torch.no_grad():
        uniform = torch.full((n_groups,), 1.0 / n_groups, dtype=_F32)
        scale = torch.clamp(torch.mean(group_time_fn(uniform)), min=1e-9)
        temps = torch.clamp(0.5 * torch.pow(
            torch.tensor(0.995, dtype=_F32), torch.arange(iters, dtype=_F32)),
            min=1e-3)
    theta = torch.zeros((n_groups,), dtype=_F32)
    with torch.enable_grad():
        for i in range(iters):
            th = theta.detach().requires_grad_(True)
            t = group_time_fn(torch.softmax(th, dim=0)) / scale
            total = temps[i] * torch.logsumexp(t / temps[i], dim=0)
            (g,) = torch.autograd.grad(total, th)
            theta = th.detach() - lr * g
    with torch.no_grad():
        f_opt = torch.softmax(theta, dim=0)
        t_opt = float(torch.max(group_time_fn(f_opt)))
    return f_opt.numpy(), t_opt
