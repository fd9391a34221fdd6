"""Plain PyTorch versions of the CUDA kernels (the correctness ground truth).

Each ``*_ref`` computes the same function as its kernel, in the same output
dtypes.  The CPU path runs them; on the card they are what ``chip_smoke.py``
holds each kernel against.  Nothing on the main path calls them when the
tensors live on a CUDA device.
"""
from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# masked_compact: the frame-masking compression hot-spot (paper §VI)
# ---------------------------------------------------------------------------
def masked_compact_ref(tokens: torch.Tensor, mask: torch.Tensor, capacity: int):
    """tokens: [B,S,D]; mask: [B,S] bool -> (out [B,K,D], idx [B,K] int32,
    count [B] int32).  Kept tokens are packed in order; overflow beyond
    ``capacity`` is dropped; empty slots are zero (idx = -1)."""
    B, S, D = tokens.shape
    K = capacity
    m = mask.to(torch.int32)
    pos = torch.cumsum(m, dim=1, dtype=torch.int32) - m          # slot per kept token
    tgt = torch.where(mask & (pos < K), pos, K).long()            # K => dropped
    b_idx = torch.arange(B, device=tokens.device)[:, None].expand(B, S)
    # one spare slot K collects every dropped row and is cut off below
    out = torch.zeros((B, K + 1, D), dtype=tokens.dtype, device=tokens.device)
    out[b_idx, tgt] = tokens
    idx = torch.full((B, K + 1), -1, dtype=torch.int32, device=tokens.device)
    idx[b_idx, tgt] = torch.arange(S, dtype=torch.int32,
                                   device=tokens.device).expand(B, S)
    count = torch.clamp(m.sum(dim=1), max=K).to(torch.int32)
    return out[:, :K], idx[:, :K], count


def masked_scatter_ref(compacted: torch.Tensor, idx: torch.Tensor, seq_len: int):
    """Inverse of masked_compact: re-expand [B,K,D] + idx -> [B,S,D]."""
    B, K, D = compacted.shape
    valid = idx >= 0
    tgt = torch.where(valid, idx, seq_len).long()
    b_idx = torch.arange(B, device=compacted.device)[:, None].expand(B, K)
    out = torch.zeros((B, seq_len + 1, D), dtype=compacted.dtype,
                      device=compacted.device)
    out[b_idx, tgt] = compacted
    return out[:, :seq_len]


# ---------------------------------------------------------------------------
# decode_attention: GQA single-token attention over a KV cache
# ---------------------------------------------------------------------------
def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len, *, window: int = 0):
    """q: [B,1,H,dh]; caches: [B,S,Hkv,dh]; cache_len: [B] or scalar int
    number of valid positions.  Returns [B,1,H,dh] in v dtype.

    Valid positions are ``len - window <= pos < len`` (the lower bound only
    when ``window > 0``).  An empty window gives 0, as the kernels do (their
    softmax denominator is clamped at 1e-20)."""
    B, _, H, dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    cl = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
    cl = cl.reshape(-1).expand(B)
    qf = q.reshape(B, Hkv, G, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)[None]                  # [1,S]
    valid = pos < cl[:, None]
    if window:
        valid &= pos >= (cl[:, None] - window)
    valid = valid[:, None, None]                                  # [B,1,1,S]
    s = s.masked_fill(~valid, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    out = out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    return out.reshape(B, 1, H, dh).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# grouped_ffn: per-expert SwiGLU FFN over the MoE capacity buffer
# ---------------------------------------------------------------------------
def grouped_ffn_ref(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, counts=None) -> torch.Tensor:
    """buf: [E,C,D]; wg/wu: [E,D,F]; wd: [E,F,D] -> [E,C,D] in buf's dtype.
    Computed in f32 from the inputs; the hidden ``h`` stays f32.  ``counts``
    ([E] ints, or None for C): rows of ``buf[e]`` at or past ``counts[e]``
    are taken as zeros, so their output rows are exactly zero."""
    xf = buf.float()
    if counts is not None:
        rows = torch.arange(buf.shape[1], device=buf.device)
        xf = torch.where((rows[None, :] < counts[:, None])[..., None], xf, 0.0)
    g = torch.bmm(xf, wg.float())
    u = torch.bmm(xf, wu.float())
    h = torch.nn.functional.silu(g) * u
    return torch.bmm(h, wd.float()).to(buf.dtype)


# ---------------------------------------------------------------------------
# ssm_scan: the Mamba-1 diagonal recurrence over the sequence axis
# ---------------------------------------------------------------------------
def ssm_scan_ref(decay: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """decay/bx: [B,S,di,N] f32; h0: [B,di,N].  Sequential oracle:
    ``h_t = decay_t * h_{t-1} + bx_t``.  Returns (h_all [B,S,di,N], h_last)."""
    h_all = torch.empty_like(decay)
    h = h0
    for s in range(decay.shape[1]):
        h = decay[:, s] * h + bx[:, s]
        h_all[:, s] = h
    return h_all, h
