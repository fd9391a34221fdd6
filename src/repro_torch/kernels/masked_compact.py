"""Wrapper of the hand-written CUDA masked-compaction kernel.

The kernel (``csrc/masked_compact.cu``) replaces the Pallas TPU kernel
``repro/kernels/masked_compact.py:masked_compact_pallas``: order-preserving
compaction of the masked rows of ``tokens`` into a ``[B, K, D]`` buffer.
Its plain version is :func:`repro_torch.kernels.ref.masked_compact_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def masked_compact_cuda(tokens: torch.Tensor, mask: torch.Tensor,
                        capacity: int):
    """tokens: [B,S,D] (any dtype, contiguous, CUDA); mask: [B,S] bool on
    the same device.  Returns (out [B,K,D] tokens dtype, idx [B,K] int32,
    count [B] int32).  Launches on the current stream and counts the launch
    in ``masked_compact_cuda.launches``."""
    if not tokens.is_cuda or mask.device != tokens.device:
        raise ValueError(f"masked_compact_cuda: tokens on {tokens.device} and "
                         f"mask on {mask.device}; both must be on one CUDA "
                         "device")
    if tokens.dim() != 3 or mask.shape != tokens.shape[:2]:
        raise ValueError(f"masked_compact_cuda: bad shapes tokens "
                         f"{tuple(tokens.shape)}, mask {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"masked_compact_cuda: mask dtype {mask.dtype}, "
                        "expected torch.bool")
    if not tokens.is_contiguous() or not mask.is_contiguous():
        raise ValueError("masked_compact_cuda: tokens and mask must be "
                         "contiguous")
    K = int(capacity)
    if K < 0:
        raise ValueError(f"masked_compact_cuda: capacity {K} < 0")
    B, S, D = tokens.shape
    if B == 0:
        raise ValueError("masked_compact_cuda: empty batch")
    out = torch.empty((B, K, D), dtype=tokens.dtype, device=tokens.device)
    idx = torch.empty((B, K), dtype=torch.int32, device=tokens.device)
    count = torch.empty((B,), dtype=torch.int32, device=tokens.device)
    lib = _build.load()
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_masked_compact(
            tokens.data_ptr(), mask.data_ptr(), out.data_ptr(), idx.data_ptr(),
            count.data_ptr(), B, S, D * tokens.element_size(), K, stream)
    _build.check(err, "masked_compact")
    masked_compact_cuda.launches += 1
    return out, idx, count


masked_compact_cuda.launches = 0
