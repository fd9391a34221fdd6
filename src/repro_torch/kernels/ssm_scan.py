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

Its backward (``repro_ssm_scan_bwd`` in the same source) walks S in reverse
with the state's adjoint in registers; the TPU had no kernel for it (JAX
differentiates its associative scan in XLA).  Its plain version is
:func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(what: str, named, B_S_shape) -> None:
    """The checks both wrappers make: every tensor f32, on decay's CUDA
    device, contiguous and 16-byte aligned; ``named[0]`` [B,S,di,N] with
    every other [B,S,di,N] or [B,di,N] as ``B_S_shape`` says; no empty
    dimension; the launch grid's range."""
    decay = named[0][1]
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != decay.device:
            raise ValueError(f"{what}: tensors on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; "
                            "the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    state = (decay.shape[0], *decay.shape[2:])
    if decay.dim() != 4 or any(
            tuple(t.shape) != (tuple(decay.shape) if full else state)
            for (_, t), full in zip(named, B_S_shape)):
        raise ValueError(f"{what}: bad shapes " + ", ".join(
            f"{name} {tuple(t.shape)}" for name, t in named))
    B, S, di, N = decay.shape
    if min(B, S, di, N) == 0:
        raise ValueError(f"{what}: empty dimension in B={B}, S={S}, "
                         f"di={di}, N={N}")
    if di * N >= 2 ** 31 or B >= 2 ** 16:
        raise ValueError(f"{what}: B={B}, di*N={di * N} past the "
                         "launch grid's range")


def ssm_scan_cuda(decay: torch.Tensor, bx: torch.Tensor,
                  h0: torch.Tensor):
    """decay/bx: [B,S,di,N] f32; h0: [B,di,N] f32 (one CUDA device,
    contiguous, 16-byte aligned).  Any positive B, S, di and N.  Returns
    (h_all [B,S,di,N], h_last [B,di,N]), both f32.  Launches on the current
    stream and counts the launch in ``ssm_scan_cuda.launches``."""
    _check("ssm_scan_cuda", (("decay", decay), ("bx", bx), ("h0", h0)),
           (True, True, False))
    B, S, di, N = decay.shape
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


def ssm_scan_bwd_cuda(decay: torch.Tensor, h_all: torch.Tensor,
                      h0: torch.Tensor, G=None, g=None):
    """The recurrence's backward.  decay/h_all: [B,S,di,N] f32 (the forward's
    input and output); h0: [B,di,N] f32; G: None or [B,S,di,N] f32, the
    gradient of h_all; g: None or [B,di,N] f32, the gradient of h_last (the
    forward wrapper's contract for every tensor given).  Returns (d_decay,
    d_bx [B,S,di,N], d_h0 [B,di,N]), f32.  Launches on the current stream and
    counts the launch in ``ssm_scan_bwd_cuda.launches``."""
    named = [("decay", decay), ("h_all", h_all), ("h0", h0)]
    full = [True, True, False]
    if G is not None:
        named.append(("G", G))
        full.append(True)
    if g is not None:
        named.append(("g", g))
        full.append(False)
    _check("ssm_scan_bwd_cuda", named, full)
    B, S, di, N = decay.shape
    d_decay = torch.empty_like(decay)
    d_bx = torch.empty_like(decay)
    d_h0 = torch.empty_like(h0)
    lib = _build.load()
    with torch.cuda.device(decay.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssm_scan_bwd(
            decay.data_ptr(), h_all.data_ptr(), h0.data_ptr(),
            None if G is None else G.data_ptr(),
            None if g is None else g.data_ptr(),
            d_decay.data_ptr(), d_bx.data_ptr(), d_h0.data_ptr(), B, S, di * N,
            stream)
    _build.check(err, "ssm_scan_bwd")
    ssm_scan_bwd_cuda.launches += 1
    return d_decay, d_bx, d_h0


ssm_scan_bwd_cuda.launches = 0
