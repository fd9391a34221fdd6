"""Wrapper of the hand-written CUDA grouped-FFN kernel.

The kernel (``csrc/grouped_ffn.cu``) replaces the Pallas TPU kernel
``repro/kernels/grouped_ffn.py:grouped_ffn_pallas``: the per-expert SwiGLU
FFN over the MoE capacity buffer, ``(silu(buf·wg) ⊙ buf·wu)·wd`` in f32,
output in buf's dtype, over the rows below ``counts[e]`` of each expert.
Its plain version is :func:`repro_torch.kernels.ref.grouped_ffn_ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build


def check_counts(counts: Optional[torch.Tensor], E: int,
                 device: torch.device) -> None:
    """Refuse a ``counts`` that is not None or an int32 [E] tensor on
    ``device`` (the rows of each expert's buffer in use)."""
    if counts is None:
        return
    if not isinstance(counts, torch.Tensor):
        raise TypeError(f"grouped_ffn: counts must be a tensor, got "
                        f"{type(counts).__name__}")
    if counts.dtype != torch.int32:
        raise TypeError(f"grouped_ffn: counts has dtype {counts.dtype}, "
                        "expected torch.int32")
    if tuple(counts.shape) != (E,):
        raise ValueError(f"grouped_ffn: counts has shape {tuple(counts.shape)}"
                         f", expected ({E},)")
    if counts.device != device:
        raise ValueError(f"grouped_ffn: counts is on {counts.device}, buf on "
                         f"{device}")


def tensor_core_path(dtype: torch.dtype, D: int, F: int) -> bool:
    """Whether a call takes the tensor-core kernel (bf16 with 16-byte rows)
    or the CUDA-core one (f32, or D or F not a multiple of 8)."""
    return dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0


def grouped_ffn_cuda(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                     wd: torch.Tensor,
                     counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """buf: [E,C,D]; wg/wu: [E,D,F]; wd: [E,F,D] (bf16 or f32, one dtype, all
    on one CUDA device, contiguous, 16-byte aligned); counts: None or int32
    [E] on the same device, the leading rows of each ``buf[e]`` in use (rows
    at or past it are read as zeros and written as zeros; None means all C).
    Any positive E, C, D and F.  Returns [E,C,D] in buf's dtype.  Runs two
    launches on the current stream (gate_up into a 4-byte [E,C,F] workspace,
    then down) without a host sync, and counts the call as one launch in
    ``grouped_ffn_cuda.launches``."""
    named = (("buf", buf), ("wg", wg), ("wu", wu), ("wd", wd))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"grouped_ffn_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != buf.device:
            raise ValueError("grouped_ffn_cuda: tensors on different devices")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"grouped_ffn_cuda: {name} has dtype {t.dtype}; "
                            "the kernel takes bfloat16 or float32")
        if t.dtype != buf.dtype:
            raise TypeError("grouped_ffn_cuda: buf, wg, wu and wd must share "
                            f"one dtype, got {[x.dtype for _, x in named]}")
        if t.dim() != 3:
            raise ValueError(f"grouped_ffn_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected 3 dimensions")
        if not t.is_contiguous():
            raise ValueError(f"grouped_ffn_cuda: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"grouped_ffn_cuda: {name} is not 16-byte aligned")
    E, C, D = buf.shape
    F = wg.shape[2]
    if tuple(wg.shape) != (E, D, F) or tuple(wu.shape) != (E, D, F) \
            or tuple(wd.shape) != (E, F, D):
        raise ValueError(f"grouped_ffn_cuda: bad shapes buf {tuple(buf.shape)}"
                         f", wg {tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}")
    if min(E, C, D, F) == 0:
        raise ValueError(f"grouped_ffn_cuda: empty dimension in E={E}, C={C}, "
                         f"D={D}, F={F}")
    check_counts(counts, E, buf.device)
    if counts is not None and not counts.is_contiguous():
        counts = counts.contiguous()
    # f32 h, or its bf16 hi/lo planes on the tensor-core path: 4 bytes a value
    h = torch.empty((E, C, F), dtype=torch.float32, device=buf.device)
    out = torch.empty_like(buf)
    lib = _build.load()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_grouped_ffn(
            buf.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            h.data_ptr(), out.data_ptr(),
            None if counts is None else counts.data_ptr(), E, C, D, F,
            int(buf.dtype == torch.bfloat16), stream)
    _build.check(err, "grouped_ffn")
    grouped_ffn_cuda.launches += 1
    return out


grouped_ffn_cuda.launches = 0
