"""Battery / charging constraints (paper §V-A.4, Eqs. 5-6), in float32.

    E_available = C0·k − E_dnn − E_drive
    P_available = E_available / ((1−k)(t_dnn + t_drive)/3600)

When available power falls below a threshold the node offloads more
aggressively.  On a fleet of cards the same control law prices a per-group
power budget (a power cap or an energy quota per serving window).  Each
function returns a 0-d float32 CPU tensor.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_F32 = torch.float32


@dataclass(frozen=True)
class BatteryState:
    capacity_wh: float = 14.8          # 4000 mAh @ 3.7 V  (RosBot/JetBot)
    discharge_rate: float = 0.7        # k — usable fraction
    drive_power_w: float = 17.5        # 15–20 W while driving
    dnn_power_w: float = 5.5           # 5–6 W DNN draw


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def available_energy(batt: BatteryState, t_dnn_s, t_drive_s) -> torch.Tensor:
    """Eq. 5 — E_available (Wh)."""
    e_dnn = batt.dnn_power_w * _f32(t_dnn_s) / 3600.0
    e_drive = batt.drive_power_w * _f32(t_drive_s) / 3600.0
    return batt.capacity_wh * batt.discharge_rate - e_dnn - e_drive


def available_power(batt: BatteryState, t_dnn_s, t_drive_s) -> torch.Tensor:
    """Eq. 6 — P_available (W)."""
    e_av = available_energy(batt, t_dnn_s, t_drive_s)
    hours = (1.0 - batt.discharge_rate) * (t_dnn_s + t_drive_s) / 3600.0
    return e_av / torch.clamp(_f32(hours), min=1e-9)


def offload_pressure(batt: BatteryState, t_dnn_s, t_drive_s,
                     power_threshold_w: float) -> torch.Tensor:
    """In [0, 1]: how hard to push work to the auxiliary node.  0 while
    P_available comfortably exceeds the threshold; towards 1 as the budget
    collapses (paper: 'starts offloading more aggressively')."""
    p = available_power(batt, t_dnn_s, t_drive_s)
    return torch.clamp(1.0 - p / torch.clamp(_f32(power_threshold_w), min=1e-9),
                       0.0, 1.0)
