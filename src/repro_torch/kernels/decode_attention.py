"""Wrapper of the hand-written CUDA decode-attention kernel.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:decode_attention_pallas``: GQA
single-token attention over a KV cache with per-slot lengths.  Its plain
version is :func:`repro_torch.kernels.ref.decode_attention_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
SMEM_LIMIT = 232448       # bytes of shared memory one Hopper block may use
_TILE = 64                # kTile in the CUDA source


def smem_bytes(G: int, dh: int) -> int:
    """Dynamic shared memory of one block (mirrors the CUDA source)."""
    return 4 * (2 * _TILE * (dh + 1) + 2 * G * dh + G * _TILE + 3 * G)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len, *,
                          window: int = 0) -> torch.Tensor:
    """q: [B,1,H,dh]; caches: [B,S,Hkv,dh] (bf16 or f32, one dtype, all on one
    CUDA device, contiguous); cache_len: [B] int tensor or a scalar.  Returns
    [B,1,H,dh] in v's dtype.  Launches on the current stream and counts the
    launch in ``decode_attention_cuda.launches``."""
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
    if B == 0:
        raise ValueError("decode_attention_cuda: empty batch")
    esize = q.element_size()
    if dh > MAX_HEAD_DIM or (dh * esize) % 16:
        raise ValueError(f"decode_attention_cuda: head_dim {dh} unsupported "
                         f"(needs <= {MAX_HEAD_DIM} and a multiple of "
                         f"{16 // esize} for {q.dtype})")
    if smem_bytes(H // Hkv, dh) > SMEM_LIMIT:
        raise ValueError(f"decode_attention_cuda: G={H // Hkv}, dh={dh} needs "
                         f"{smem_bytes(H // Hkv, dh)} bytes of shared memory")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("decode_attention_cuda: tensors on different devices")
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.dim() > 1 or (cl.dim() == 1 and cl.numel() not in (1, B)):
        raise ValueError(f"decode_attention_cuda: cache_len shape "
                         f"{tuple(cl.shape)} is neither scalar nor [{B}]")
    cl = cl.to(torch.int32).reshape(-1).expand(B).contiguous()
    out = torch.empty_like(q, dtype=v_cache.dtype)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cl.data_ptr(), out.data_ptr(), B, S, H, Hkv, dh, int(window),
            int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
