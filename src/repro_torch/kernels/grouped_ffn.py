"""Wrappers of the hand-written CUDA grouped-FFN kernels.

The capacity kernel (``csrc/grouped_ffn.cu``) replaces the Pallas TPU
kernel ``repro/kernels/grouped_ffn.py:grouped_ffn_pallas``: the per-expert
SwiGLU FFN over the MoE capacity buffer, ``(silu(buf·wg) ⊙ buf·wu)·wd`` in
f32, output in buf's dtype, over the rows below ``counts[e]`` of each
expert.  Its plain version is :func:`repro_torch.kernels.ref.grouped_ffn_ref`.

The sorted kernel (``csrc/grouped_ffn_sorted.cu``) computes the same FFN
over rows sorted by expert, each expert's rows ``offsets[e] <= r <
offsets[e + 1]``: the dropless MoE's prefill, with each expert's weights
read once a layer.  Its plain version is
:func:`repro_torch.kernels.ref.grouped_ffn_sorted_ref`.
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


OFF_CARD = "not on one CUDA device"


def sorted_refusal(xs: torch.Tensor, wg: torch.Tensor) -> Optional[str]:
    """Why ``grouped_ffn_sorted_cuda`` does not take rows ``xs`` [R,D] and
    weights ``wg`` [E,D,F] (and ``wu``, ``wd`` alike), or None where it
    does: no gradient wanted, bf16, D and F multiples of 8 (16-byte rows,
    as TMA reads them), on one CUDA device (:data:`OFF_CARD`, asked
    last)."""
    if torch.is_grad_enabled() and (xs.requires_grad or wg.requires_grad):
        return "a gradient is wanted"
    if not xs.dtype == wg.dtype == torch.bfloat16:
        return f"dtypes {xs.dtype}, {wg.dtype}, not bfloat16"
    D, F = wg.shape[-2], wg.shape[-1]
    if D % 8 or F % 8:
        return f"D={D}, F={F}: not multiples of 8"
    if not (xs.is_cuda and wg.device == xs.device):
        return OFF_CARD
    return None


def grouped_ffn_sorted_cuda(xs: torch.Tensor, wg: torch.Tensor,
                            wu: torch.Tensor, wd: torch.Tensor,
                            offsets: torch.Tensor) -> torch.Tensor:
    """xs: [R,D] rows sorted by expert; wg/wu: [E,D,F]; wd: [E,F,D] (bf16,
    one CUDA device, contiguous, 16-byte aligned, D and F multiples of 8);
    offsets: int32 [E+1] on the same device, expert e's rows ``offsets[e]
    <= r < offsets[e+1]`` (non-decreasing, ``offsets[E] <= R``).  Returns
    ys [R,D] bf16: each row's SwiGLU through its expert, rows past
    ``offsets[E]`` left unwritten.  Two launches on the current stream
    (gate_up into a 4-byte [2,R,F] workspace, then down) without a host
    sync, counted as one in ``grouped_ffn_sorted_cuda.launches``."""
    named = (("xs", xs), ("wg", wg), ("wu", wu), ("wd", wd))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"grouped_ffn_sorted_cuda: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != xs.device:
            raise ValueError("grouped_ffn_sorted_cuda: tensors on different "
                             "devices")
        if not t.is_contiguous():
            raise ValueError(f"grouped_ffn_sorted_cuda: {name} is not "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"grouped_ffn_sorted_cuda: {name} is not 16-byte"
                             " aligned")
    if xs.dim() != 2 or wg.dim() != 3:
        raise ValueError(f"grouped_ffn_sorted_cuda: xs {tuple(xs.shape)} and "
                         f"wg {tuple(wg.shape)}: expected [R,D] and [E,D,F]")
    R, D = xs.shape
    E, F = wg.shape[0], wg.shape[2]
    if tuple(wg.shape) != (E, D, F) or tuple(wu.shape) != (E, D, F) \
            or tuple(wd.shape) != (E, F, D):
        raise ValueError(f"grouped_ffn_sorted_cuda: bad shapes xs "
                         f"{tuple(xs.shape)}, wg {tuple(wg.shape)}, wu "
                         f"{tuple(wu.shape)}, wd {tuple(wd.shape)}")
    if min(R, E, D, F) == 0:
        raise ValueError(f"grouped_ffn_sorted_cuda: empty dimension in R={R}, "
                         f"E={E}, D={D}, F={F}")
    if {t.dtype for _, t in named} != {torch.bfloat16} or D % 8 or F % 8:
        raise TypeError(f"grouped_ffn_sorted_cuda: dtypes "
                        f"{[t.dtype for _, t in named]}, D={D}, F={F}: the "
                        "kernel takes bfloat16 with D and F multiples of 8")
    if not isinstance(offsets, torch.Tensor) or offsets.dtype != torch.int32 \
            or tuple(offsets.shape) != (E + 1,) or offsets.device != xs.device:
        raise ValueError(f"grouped_ffn_sorted_cuda: offsets must be an int32 "
                         f"[{E + 1}] tensor on {xs.device}")
    offsets = offsets.contiguous()
    h = torch.empty((2, R, F), dtype=torch.bfloat16, device=xs.device)
    ys = torch.empty_like(xs)
    lib = _build.load()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_grouped_ffn_sorted(
            xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            offsets.data_ptr(), h.data_ptr(), ys.data_ptr(), R, E, D, F,
            stream)
    _build.check(err, "grouped_ffn_sorted")
    grouped_ffn_sorted_cuda.launches += 1
    return ys


grouped_ffn_sorted_cuda.launches = 0
