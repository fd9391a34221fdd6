"""The benchmark's yardstick: the chip's peaks and the work formulas.

Everything a metric divides by lives here, under the benchmark's own
folder, so that a change to the program cannot move it.

* ``PEAKS``: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates).
* :func:`decode_attention_cost`: a frozen copy of the port's
  ``kernels/costs.py:decode_attention`` (the K and V rows a decode call
  must read, q read and the output written, the lengths read).
* :func:`roofline_seconds`: the least time of a cost on the chip, the
  larger of its operations over the bf16 peak and its bytes over the
  memory rate.
"""
from __future__ import annotations

from typing import Dict

PEAKS: Dict[str, float] = {
    "bf16_flops": 989e12,          # dense bf16 / fp16 tensor-core rate
    "hbm_bytes": 3.35e12,          # HBM3 bytes per second
}


def decode_attention_cost(B: int, H: int, Hkv: int, dh: int, rows: int,
                          esize: int) -> Dict[str, float]:
    """One GQA decode call over ``rows`` K/V rows summed over its ``B``
    slots: K and V rows read, q read and out written, the int32 lengths
    read; q.k and p.v at 2 operations a multiply-add."""
    n_bytes = (2 * rows * Hkv * dh * esize
               + 2 * B * H * dh * esize
               + 4 * B)
    return {"flops": 4 * H * rows * dh, "bytes": n_bytes}


def roofline_seconds(flops: float, n_bytes: float) -> float:
    """The least time: the larger of the two terms."""
    return max(flops / PEAKS["bf16_flops"], n_bytes / PEAKS["hbm_bytes"])
