"""Wrapper of the hand-written CUDA MLA decode-attention kernel (split-K).

The kernel (``csrc/mla_decode_attention.cu``) replaces no Pallas kernel:
the JAX package has no latent attention.  It computes
:func:`repro_torch.kernels.ref.mla_decode_attention_ref`: each slot's
absorbed query [H, 576] against its first ``cache_len`` rows of the latent
cache [S, 576], the softmax scale the caller gives, and V = a row's first
512 values.  ``models/attention.py:mla_decode_attend`` sends a call here
unless :func:`refusal` names a reason.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
# the decode kernel's per-stream ticket counters: each kernel leaves the
# ones it used at zero, and launches on one stream run one after another
from repro_torch.kernels.decode_attention import _ticket_buffer

WIDTH = 576            # kWidth in the CUDA source: a latent row
V_WIDTH = 512          # kVWidth: V, a row's first values
MAX_HEADS = 16         # kHeads: the mma's M
TILE_ROWS = 32         # kRows: a split is a multiple of a tile
MAX_SPLITS = 159       # kMaxSplits
TARGET_BLOCKS = 4 * 132    # blocks a call aims for: four per SM of an H100
MIN_SPLIT_ROWS = 256   # below this a split's merge costs more than it saves

OFF_CARD = "not on one CUDA device"


def refusal(q: torch.Tensor, latent: torch.Tensor, v_dim: int) -> Optional[str]:
    """Why the kernel does not take a call, or None where it does: bf16,
    rows of :data:`WIDTH` with V their first :data:`V_WIDTH`, at most
    :data:`MAX_HEADS` heads, no gradient wanted, on one CUDA device
    (:data:`OFF_CARD`, asked last)."""
    if q.requires_grad or latent.requires_grad:
        return "a gradient is wanted"
    if not q.dtype == latent.dtype == torch.bfloat16:
        return f"dtypes {q.dtype}, {latent.dtype}, not bfloat16"
    if q.shape[-1] != WIDTH or latent.shape[-1] != WIDTH or v_dim != V_WIDTH:
        return (f"rows of {latent.shape[-1]} with V {v_dim}, not {WIDTH} "
                f"with V {V_WIDTH}")
    if not 0 < q.shape[1] <= MAX_HEADS:
        return f"{q.shape[1]} heads, not 1 to {MAX_HEADS}"
    if q.shape[0] == 0 or latent.shape[1] == 0:
        return "no slot or no row"
    if not (q.is_cuda and latent.device == q.device):
        return OFF_CARD
    return None


def num_splits(B: int, S: int) -> Tuple[int, int]:
    """(splits, rows_per_split) of a call, from B and S alone (the lengths
    stay on the device): B x splits reaches TARGET_BLOCKS where S allows,
    with at least MIN_SPLIT_ROWS rows a split, each a multiple of
    TILE_ROWS; together they cover rows [0, S) and none is empty."""
    want = max(1, -(-TARGET_BLOCKS // B))
    rows = max(MIN_SPLIT_ROWS, -(-S // want), -(-S // MAX_SPLITS))
    rows = -(-rows // TILE_ROWS) * TILE_ROWS
    return max(1, -(-S // rows)), rows


def mla_decode_attention_cuda(q: torch.Tensor, latent: torch.Tensor, cache_len,
                              *, scale: float) -> torch.Tensor:
    """q: [B,H,576] (the absorbed query); latent: [B,S,576] (bf16, on one
    CUDA device, contiguous, 16-byte aligned); cache_len: [B] int tensor,
    a scalar tensor or a Python int.  Returns [B,H,512] bf16.  Launches on
    the current stream without a host sync and counts the launch in
    ``mla_decode_attention_cuda.launches``."""
    for name, t in (("q", q), ("latent", latent)):
        if not t.is_cuda:
            raise ValueError(f"mla_decode_attention_cuda: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mla_decode_attention_cuda: {name} has dtype "
                            f"{t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"mla_decode_attention_cuda: {name} is not "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"mla_decode_attention_cuda: {name} is not "
                             "16-byte aligned")
    if q.dim() != 3 or latent.dim() != 3 or q.shape[0] != latent.shape[0] \
            or q.shape[2] != WIDTH or latent.shape[2] != WIDTH:
        raise ValueError(f"mla_decode_attention_cuda: bad shapes q "
                         f"{tuple(q.shape)}, latent {tuple(latent.shape)}")
    B, H, _ = q.shape
    S = latent.shape[1]
    if not 0 < H <= MAX_HEADS or B == 0 or S == 0:
        raise ValueError(f"mla_decode_attention_cuda: B={B}, H={H}, S={S} "
                         f"(takes 1 to {MAX_HEADS} heads)")
    if latent.device != q.device:
        raise ValueError("mla_decode_attention_cuda: tensors on different "
                         "devices")
    if isinstance(cache_len, int):
        cl = torch.full((B,), cache_len, dtype=torch.int32, device=q.device)
    else:
        cl = torch.as_tensor(cache_len, device=q.device)
        if cl.dim() > 1 or (cl.dim() == 1 and cl.numel() not in (1, B)):
            raise ValueError(f"mla_decode_attention_cuda: cache_len shape "
                             f"{tuple(cl.shape)} is neither scalar nor [{B}]")
        cl = cl.to(torch.int32).reshape(-1).expand(B).contiguous()
    splits, rows = num_splits(B, S)
    out = torch.empty((B, H, V_WIDTH), dtype=torch.bfloat16, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part = tickets = None
        if splits > 1:     # f32 (acc[16][512], m, l) per (slot, split)
            part = torch.empty(B * splits * MAX_HEADS * (V_WIDTH + 2),
                               dtype=torch.float32, device=q.device)
            tickets = _ticket_buffer(q.device, stream, B)
        err = lib.repro_mla_decode_attention(
            q.data_ptr(), latent.data_ptr(), cl.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            B, H, S, splits, rows, float(scale), stream)
    _build.check(err, "mla_decode_attention")
    mla_decode_attention_cuda.launches += 1
    return out


mla_decode_attention_cuda.launches = 0
