"""GQA self-attention with a KV cache.

Prefill uses the chunked online-softmax formulation of the JAX package
(plain tensor code, the same masks and padding sentinels).  Decode is one
query token against the cache: with kernels on it goes through the
hand-written CUDA ``decode_attention`` kernel, else through its plain
version.  Cross-attention, the int8 KV cache and prefix resume are not
ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, norm_apply, normal_stack


def attn_init(gen: torch.Generator, cfg, dtype, device, n_layers: int) -> dict:
    """L-stacked attention weights at the JAX package's init scales."""
    d, h, hkv, dh, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, n_layers)

    def normal(shape, scale):
        return normal_stack(gen, shape, scale, dtype, device)

    s = 1.0 / math.sqrt(d)
    p = {"wq": normal((L, d, h, dh), s),
         "wk": normal((L, d, hkv, dh), s),
         "wv": normal((L, d, hkv, dh), s),
         "wo": normal((L, h, dh, d), 1.0 / math.sqrt(h * dh))}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((L, dh), device=device)}
        p["k_norm"] = {"scale": torch.ones((L, dh), device=device)}
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


class _RMS:  # rmsnorm over head_dim (qk-norm)
    norm_type = "rmsnorm"


def _qkv(params, x, kv_x, cfg, q_positions, kv_positions, *, rope: bool):
    q = _proj(x, params["wq"])
    k = _proj(kv_x, params["wk"])
    v = _proj(kv_x, params["wv"])
    if "q_norm" in params:
        q = norm_apply(params["q_norm"], q, _RMS)
        k = norm_apply(params["k_norm"], k, _RMS)
    if rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
def chunked_attention(q, k, v, *, causal: bool, window: int,
                      q_positions, kv_positions,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Online-softmax attention.

    q: [B,Sq,H,dh]; k,v: [B,Sk,Hkv,dh]; positions give global indices used
    for the causal / sliding-window mask (padded queries carry -1, padded
    keys 2**30).  Returns [B,Sq,H,dh] in v's dtype.
    """
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    pq = (-Sq) % q_chunk
    pk = (-Sk) % kv_chunk
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        q_positions = torch.nn.functional.pad(q_positions, (0, pq), value=-1)
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pk),
                                               value=2**30)
    nq, nk = q.shape[1] // q_chunk, k.shape[1] // kv_chunk
    scale = 1.0 / math.sqrt(dh)

    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk].float()       # [B,Cq,H,dh]
        qpos = q_positions[qi * q_chunk:(qi + 1) * q_chunk]       # [Cq]
        m = torch.full((B, H, q_chunk), -math.inf, device=q.device)
        l = torch.zeros((B, H, q_chunk), device=q.device)
        acc = torch.zeros((B, H, q_chunk, dh), device=q.device)
        for ki in range(nk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kc, vc, kpos = k[:, sl].float(), v[:, sl].float(), kv_positions[sl]
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
            mask = kpos[None, :] < 2**30                          # padding keys
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window:
                mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]          # [B,H,Cq,dh]
        outs.append(out.permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1)[:, :Sq].to(v.dtype)


# ---------------------------------------------------------------------------
def cache_update(cache: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """Write one token's K or V into ``cache`` [B,S,Hkv,dh] at ``index``
    (sequence axis 1), IN PLACE -- the JAX engine donates the cache, so the
    port updates the buffer it was given and returns it.

    ``index`` is a scalar (every row at one position) or a per-slot [B]
    tensor.  Like ``dynamic_update_slice`` an out-of-range index is clamped
    into [0, S-1]."""
    B, S = cache.shape[:2]
    index = torch.as_tensor(index, device=cache.device)
    new = new.to(cache.dtype)
    if index.dim():
        rows = torch.arange(B, device=cache.device)
        cache[rows, index.clamp(0, S - 1).long()] = new[:, 0]
    else:
        cache.index_copy_(1, index.clamp(0, S - 1).long().reshape(1), new)
    return cache


def attn_apply(params, x, cfg, *, positions, mode: str, causal: bool = True,
               cache=None, cache_index=None, use_kernels: bool = False,
               kv_x=None, prefix_kv=None):
    """mode "full":   self-attention over x (prefill); returns (out, (k, v)).
    mode "decode": x is [B,1,D]; cache = {"k","v"} [B,S,Hkv,dh], updated in
                   place at ``cache_index`` (scalar or [B]); returns
                   (out, cache).
    ``kv_x`` (cross-attention) and ``prefix_kv`` (prefix resume) are not
    ported yet."""
    if kv_x is not None:
        raise NotImplementedError("cross-attention is not ported yet")
    if prefix_kv is not None:
        raise NotImplementedError("prefix resume is not ported yet")
    if mode == "full":
        q, k, v = _qkv(params, x, x, cfg, positions, positions, rope=True)
        out = chunked_attention(q, k, v, causal=causal,
                                window=cfg.sliding_window,
                                q_positions=positions, kv_positions=positions)
        return _out_proj(out.to(x.dtype), params["wo"]), (k, v)

    if mode != "decode":
        raise ValueError(f"unknown attention mode {mode!r}")
    if "k_scale" in cache:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    q, k, v = _qkv(params, x, x, cfg, positions, positions, rope=True)
    k_cache = cache_update(cache["k"], k, cache_index)
    v_cache = cache_update(cache["v"], v, cache_index)
    cache_len = cache_index + 1
    out = ops.decode_attention(q, k_cache, v_cache, cache_len,
                               window=cfg.sliding_window, use_kernels=use_kernels)
    return _out_proj(out.to(x.dtype), params["wo"]), {"k": k_cache, "v": v_cache}
