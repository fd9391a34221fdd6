"""Public kernel entry points, and the one place that picks kernel or plain.

A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor, or a call with ``use_kernels=False``, takes the plain PyTorch
version.  There is no fallback from the kernel to the plain version.
``use_kernels`` is the port's counterpart of the JAX package's
``use_pallas``: ``"auto"`` means "the tensors are on CUDA".
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.grouped_ffn import check_counts, grouped_ffn_cuda
from repro_torch.kernels.masked_compact import masked_compact_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_cuda

_WRAPPERS = {"decode_attention": decode_attention_cuda,
             "masked_compact": masked_compact_cuda,
             "grouped_ffn": grouped_ffn_cuda,
             "ssm_scan": ssm_scan_cuda}


def resolve_use_kernels(use_kernels: Union[bool, str],
                        device: torch.device) -> bool:
    """``"auto"`` -> kernels exactly when ``device`` is a CUDA device."""
    if use_kernels == "auto":
        return torch.device(device).type == "cuda"
    return bool(use_kernels)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     use_kernels: bool = True):
    """q: [B,1,H,dh]; caches: [B,S,Hkv,dh]; cache_len: [B] or scalar.
    ``use_kernels=False`` takes the plain version on any device."""
    if use_kernels and q.is_cuda:
        return decode_attention_cuda(q.contiguous(), k_cache, v_cache,
                                     cache_len, window=window)
    return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    window=window)


def masked_compact(tokens, mask, capacity: int, *, use_kernels: bool = True):
    """tokens: [B,S,D]; mask: [B,S] bool -> (out [B,K,D], idx [B,K], count [B]).
    ``use_kernels=False`` takes the plain version on any device."""
    if use_kernels and tokens.is_cuda:
        return masked_compact_cuda(tokens, mask, capacity)
    return ref.masked_compact_ref(tokens, mask, capacity)


def grouped_ffn(buf, wg, wu, wd, *, counts=None, use_kernels: bool = True):
    """buf: [E,C,D]; wg/wu: [E,D,F]; wd: [E,F,D] -> [E,C,D] in buf's dtype.
    ``counts``: None or int32 [E] on buf's device, the leading rows of each
    ``buf[e]`` in use (the rest are taken as zeros and give zero rows).
    ``use_kernels=False`` takes the plain version on any device."""
    check_counts(counts, buf.shape[0], buf.device)
    if use_kernels and buf.is_cuda:
        return grouped_ffn_cuda(buf, wg, wu, wd, counts)
    return ref.grouped_ffn_ref(buf, wg, wu, wd, counts)


def ssm_scan(decay, bx, h0, *, use_kernels: bool = True):
    """decay/bx: [B,S,di,N] f32; h0: [B,di,N] f32 -> (h_all [B,S,di,N],
    h_last [B,di,N]), both f32.  ``use_kernels=False`` takes the plain
    version on any device."""
    if use_kernels and decay.is_cuda:
        return ssm_scan_cuda(decay, bx, h0)
    return ref.ssm_scan_ref(decay, bx, h0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
