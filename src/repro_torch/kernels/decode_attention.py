"""Wrapper of the hand-written CUDA decode-attention kernel (split-K).

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:decode_attention_pallas``: GQA
single-token attention over a KV cache with per-slot lengths.  Its plain
version is :func:`repro_torch.kernels.ref.decode_attention_ref`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
SMEM_LIMIT = 232448       # bytes of shared memory one Hopper block may use
TARGET_BLOCKS = 4 * 132   # blocks a call aims for: four per SM of an H100
SPLIT_ROWS = 64           # a split is a multiple of the block's 4 x 16-row tiles
MIN_SPLIT_ROWS = 512      # below this a split's merge costs more than it saves
MAX_G = 8                 # kMaxG in the CUDA source: query heads per block
_WARPS, _ROWS = 4, 8      # kWarps, kRows in the CUDA source

# (device index, stream) -> int32 ticket counters, zero between calls (the
# last block of each (b, kv_head) resets its own)
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def num_splits(B: int, Hkv: int, S: int, G: int = 1) -> Tuple[int, int]:
    """(splits, rows_per_split) of a call: the split count from the shapes
    alone (never from cache_len, which stays on the device), so that
    B x Hkv x head groups x splits reaches TARGET_BLOCKS where S allows,
    with at least MIN_SPLIT_ROWS rows a split (a short cache is one split:
    no merge).  Splits are runs of ``rows_per_split`` rows (a multiple of
    SPLIT_ROWS); together they cover rows [0, S) and none is empty."""
    blocks = B * Hkv * -(-G // MAX_G)
    want = max(1, -(-TARGET_BLOCKS // max(blocks, 1)))
    rows = -(-max(MIN_SPLIT_ROWS, -(-S // want)) // SPLIT_ROWS) * SPLIT_ROWS
    return max(1, -(-S // rows)), rows


TC_HEAD_DIMS = (64, 80, 128)   # bf16 head widths the tensor-core kernel takes
_TC_ROWS, _TC_STAGES = 16, 3   # kTcRows, kTcStages in the CUDA source


def tensor_core_path(dtype: torch.dtype, dh: int) -> bool:
    """Whether a call takes the tensor-core kernel (bf16, dh 64, 80 or 128)
    or the CUDA-core one (f32, and other bf16 head widths)."""
    return dtype == torch.bfloat16 and dh in TC_HEAD_DIMS


def stages(dh: int, esize: int) -> int:
    """Ring slots per warp of the CUDA-core kernel (``stages_for``)."""
    return 2 if esize == 4 and dh > 128 else 4


def smem_bytes(dh: int, esize: int, splits: int = 1,
               tensor_cores: bool = False) -> int:
    """Dynamic shared memory of one block (mirrors ``region_bytes`` in the
    CUDA source): the warps' rings of K and V row tiles, or, once they are
    drained, the merge's f32 states and split weights; the CUDA-core kernel
    keeps q in f32 after them (the tensor-core one stages q in a ring slot)."""
    if tensor_cores:
        ring = _WARPS * _TC_STAGES * 2 * _TC_ROWS * (2 * dh + 16)
    else:
        ring = _WARPS * stages(dh, esize) * 2 * _ROWS * (dh * esize + 16)
    merge = 4 * (_WARPS * MAX_G * (dh + 2) + MAX_G * (splits + 1))
    region = -(-max(ring, merge) // 16) * 16
    return region if tensor_cores else region + MAX_G * dh * 4


def _ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _tickets.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[(device.index, stream)] = buf
    return buf


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len, *,
                          window: int = 0) -> torch.Tensor:
    """q: [B,1,H,dh]; caches: [B,S,Hkv,dh] (bf16 or f32, one dtype, all on one
    CUDA device, contiguous); cache_len: [B] int tensor or a scalar.  Returns
    [B,1,H,dh] in v's dtype.  Launches on the current stream without a host
    sync and counts the launch in ``decode_attention_cuda.launches``."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_cuda:
            raise ValueError(f"decode_attention_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention_cuda: {name} is not contiguous")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"decode_attention_cuda: {name} has dtype "
                            f"{t.dtype}; the kernel takes bfloat16 or float32")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention_cuda: {name} is not 16-byte "
                             "aligned")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("decode_attention_cuda: q, k_cache and v_cache must "
                        f"share one dtype, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention_cuda: bad shapes q {tuple(q.shape)}"
                         f", k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    B, _, H, dh = q.shape
    Bk, S, Hkv, dhk = k_cache.shape
    if Bk != B or dhk != dh or Hkv == 0 or H % Hkv:
        raise ValueError(f"decode_attention_cuda: q {tuple(q.shape)} does not "
                         f"match cache {tuple(k_cache.shape)}")
    if B == 0 or S == 0:
        raise ValueError(f"decode_attention_cuda: empty batch or cache "
                         f"(B={B}, S={S})")
    esize = q.element_size()
    if dh > MAX_HEAD_DIM or (dh * esize) % 16:
        raise ValueError(f"decode_attention_cuda: head_dim {dh} unsupported "
                         f"(needs <= {MAX_HEAD_DIM} and a multiple of "
                         f"{16 // esize} for {q.dtype})")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("decode_attention_cuda: tensors on different devices")
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.dim() > 1 or (cl.dim() == 1 and cl.numel() not in (1, B)):
        raise ValueError(f"decode_attention_cuda: cache_len shape "
                         f"{tuple(cl.shape)} is neither scalar nor [{B}]")
    cl = cl.to(torch.int32).reshape(-1).expand(B).contiguous()
    G = H // Hkv
    splits, rows = num_splits(B, Hkv, S, G)
    need = smem_bytes(dh, esize, splits, tensor_core_path(q.dtype, dh))
    if need > SMEM_LIMIT:
        raise ValueError(f"decode_attention_cuda: dh={dh} with {splits} splits "
                         f"needs {need} bytes of shared memory")
    out = torch.empty_like(q, dtype=v_cache.dtype)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part = tickets = None
        if splits > 1:     # f32 (acc[G][dh], m, l) per (b, kv_head, split)
            part = torch.empty(B * Hkv * splits * G * (dh + 2),
                               dtype=torch.float32, device=q.device)
            tickets = _ticket_buffer(q.device, stream,
                                     B * Hkv * -(-G // MAX_G))
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cl.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            B, S, H, Hkv, dh, int(window), splits, rows,
            int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
