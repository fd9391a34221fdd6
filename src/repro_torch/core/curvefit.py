"""Polynomial least-squares curve fitting (paper Eqs. 1-3), in float32.

    T1(r) = a1 r² + a2 r + c1          T2(1-r) = b1(1-r)² + b2(1-r) + c2
    E(r)  = cubic                      M(r)  = quadratic
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class PolyFit:
    coeffs: torch.Tensor  # float32, highest degree first (like np.polyval)
    r2: float             # adjusted R²

    def __call__(self, x) -> torch.Tensor:
        """Horner evaluation in float32."""
        x = torch.as_tensor(x, dtype=torch.float32)
        y = torch.zeros_like(x)
        for c in self.coeffs:
            y = y * x + c
        return y


def polyfit(x, y, degree: int) -> PolyFit:
    """Least-squares polynomial fit (SVD solver, float32) with adjusted R²."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    V = torch.stack([x ** p for p in range(degree, -1, -1)], dim=1)  # [n, d+1]
    coeffs = torch.linalg.lstsq(V, y[:, None], driver="gelsd").solution[:, 0]
    pred = V @ coeffs
    ss_res = torch.sum((y - pred) ** 2)
    ss_tot = torch.sum((y - y.mean()) ** 2)
    n, p = x.shape[0], degree + 1
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)
    adj = 1.0 - (1.0 - r2) * (n - 1) / max(n - p, 1)
    return PolyFit(coeffs, float(adj))


@dataclass
class FittedModels:
    """The full Eq. 1-3 family for one (primary, auxiliary) pair."""
    T1: PolyFit   # auxiliary exec time vs r        (quadratic)
    T2: PolyFit   # primary exec time vs r          (quadratic in 1-r; stored vs r)
    T3: PolyFit   # offload latency vs r            (quadratic)
    E1: PolyFit   # auxiliary energy vs r           (cubic)
    E2: PolyFit   # primary energy vs r             (cubic)
    M1: PolyFit   # auxiliary memory vs r           (quadratic)
    M2: PolyFit   # primary memory vs r             (quadratic)


def fit_profiles(aux_prof, pri_prof, off_prof) -> FittedModels:
    """Fit the paper's model family from MeasuredProfiles (§V-A)."""
    r_a, T1, P1, M1 = aux_prof.arrays()
    r_p, T2, P2, M2 = pri_prof.arrays()
    r_o, T3, _, _ = off_prof.arrays()
    # energy = power × time (the tables report average power over the run)
    E1 = P1 * T1
    E2 = P2 * T2
    return FittedModels(
        T1=polyfit(r_a, T1, 2),
        T2=polyfit(r_p, T2, 2),
        T3=polyfit(r_o, T3, 2),
        E1=polyfit(r_a, E1, 3),
        E2=polyfit(r_p, E2, 3),
        M1=polyfit(r_a, M1, 2),
        M2=polyfit(r_p, M2, 2),
    )
