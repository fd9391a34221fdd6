"""Wrapper of the hand-written CUDA selective-scan kernel.

The kernel (``csrc/ssm_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssm_scan.py:ssm_scan_pallas``: the Mamba-1 diagonal
recurrence ``h_t = decay_t * h_{t-1} + bx_t`` over the sequence axis, every
state and the last one returned in f32.  It is bound by memory (the
``[B,S,di,N]`` inputs and output move once; two flops per element): one
thread walks S for a float4 of channels with ``h`` in registers, coalesced
along ``di*N``, so there is no carry between blocks and no scan tree.  Its
plain version is :func:`repro_torch.kernels.ref.ssm_scan_ref`, which it
matches bit for bit (no FMA contraction).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def ssm_scan_cuda(decay: torch.Tensor, bx: torch.Tensor,
                  h0: torch.Tensor):
    """decay/bx: [B,S,di,N] f32; h0: [B,di,N] f32 (one CUDA device,
    contiguous, 16-byte aligned).  Any positive B, S, di and N.  Returns
    (h_all [B,S,di,N], h_last [B,di,N]), both f32.  Launches on the current
    stream and counts the launch in ``ssm_scan_cuda.launches``."""
    named = (("decay", decay), ("bx", bx), ("h0", h0))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssm_scan_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != decay.device:
            raise ValueError("ssm_scan_cuda: tensors on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan_cuda: {name} has dtype {t.dtype}; "
                            "the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan_cuda: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"ssm_scan_cuda: {name} is not 16-byte aligned")
    if decay.dim() != 4 or bx.shape != decay.shape \
            or h0.shape != (decay.shape[0], *decay.shape[2:]):
        raise ValueError(f"ssm_scan_cuda: bad shapes decay "
                         f"{tuple(decay.shape)}, bx {tuple(bx.shape)}, h0 "
                         f"{tuple(h0.shape)}")
    B, S, di, N = decay.shape
    if min(B, S, di, N) == 0:
        raise ValueError(f"ssm_scan_cuda: empty dimension in B={B}, S={S}, "
                         f"di={di}, N={N}")
    if di * N >= 2 ** 31 or B >= 2 ** 16:
        raise ValueError(f"ssm_scan_cuda: B={B}, di*N={di * N} past the "
                         "launch grid's range")
    h_all = torch.empty_like(decay)
    h_last = torch.empty_like(h0)
    lib = _build.load()
    with torch.cuda.device(decay.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssm_scan(decay.data_ptr(), bx.data_ptr(), h0.data_ptr(),
                                 h_all.data_ptr(), h_last.data_ptr(), B, S,
                                 di * N, stream)
    _build.check(err, "ssm_scan")
    ssm_scan_cuda.launches += 1
    return h_all, h_last


ssm_scan_cuda.launches = 0
