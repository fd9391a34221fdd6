"""Link / network models (paper §V-A.2), in float32.

Shannon–Hartley data rate:  D_R = B · log2(1 + d^{-u} · P_t / N0)
Offload latency:            T_o = C / D_R        (C = offloaded bytes·8)
Offload energy:             E_o = T_o · (P_t + P_r)

``is_ici`` marks a deterministic interconnect (bytes/s with a congestion
derating) instead of a radio channel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LinkModel:
    bandwidth_hz: float          # channel bandwidth B (Hz) — or link bytes/s
    tx_power: float = 0.1        # P_t (W)
    rx_power: float = 0.1        # P_r (W)
    noise_power: float = 1e-9    # N0 (W)
    path_loss_exp: float = 2.0   # u  (0 => lossless medium)
    is_ici: bool = False         # deterministic interconnect mode
    congestion: float = 0.0      # fractional derating for the interconnect


def with_bandwidth(link: LinkModel, bandwidth_hz: float) -> LinkModel:
    """A copy of ``link`` at another live bandwidth (the mobility trace's
    per-wave update); powers, path loss and mode are kept."""
    return dataclasses.replace(link, bandwidth_hz=float(bandwidth_hz))


def data_rate(link: LinkModel, distance_m=1.0) -> torch.Tensor:
    """bits/s (radio) or bytes/s (interconnect), float32."""
    if link.is_ici:
        return torch.tensor(link.bandwidth_hz * (1.0 - link.congestion),
                            dtype=torch.float32)
    d = torch.clamp(torch.as_tensor(distance_m, dtype=torch.float32), min=1e-3)
    snr = (d ** (-link.path_loss_exp)) * link.tx_power / link.noise_power
    return link.bandwidth_hz * torch.log2(1.0 + snr)


def offload_latency(link: LinkModel, payload_bytes, distance_m=1.0) -> float:
    """T_o = C / D_R  (paper), payload in bytes; seconds."""
    rate = data_rate(link, distance_m)
    bits = torch.as_tensor(payload_bytes, dtype=torch.float32) \
        * (1.0 if link.is_ici else 8.0)
    return float(bits / torch.clamp(rate, min=1.0))


def offload_energy(link: LinkModel, payload_bytes, distance_m=1.0) -> float:
    """E_o = T_o · Σ P_i  (sender + receiver); joules."""
    t_o = torch.tensor(offload_latency(link, payload_bytes, distance_m),
                       dtype=torch.float32)
    return float(t_o * (link.tx_power + link.rx_power))


# Reference links used in benchmarks -----------------------------------------
WIFI_2_4GHZ = LinkModel(bandwidth_hz=20e6, tx_power=0.1, noise_power=3e-9)
WIFI_5GHZ = LinkModel(bandwidth_hz=80e6, tx_power=0.1, noise_power=3e-9)
ICI_LINK = LinkModel(bandwidth_hz=50e9, is_ici=True)             # 50 GB/s
DCN_LINK = LinkModel(bandwidth_hz=6.25e9, is_ici=True)           # cross-pod
