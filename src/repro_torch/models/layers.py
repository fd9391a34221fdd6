"""Shared neural layers: norms, MLP, RoPE, embeddings.

Plain functions on tensors; params are dicts in the JAX package's keys and
layout, so the L-stacked trees of both packages compare like with like.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def normal_stack(gen: torch.Generator, shape, scale: float, dtype,
                 device) -> torch.Tensor:
    """N(0, scale**2) draws of ``shape`` in ``dtype``, made one slice of the
    leading (layer) axis at a time into a preallocated tensor, so the f32
    transient is one layer's and not the whole stack's (moonshot's
    [48,64,2048,1408] expert stacks would need 35 GB each in f32)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen, device=device) * scale
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_init(cfg, d: int, device) -> dict:
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "nonparametric":
        return {}
    raise ValueError(cfg.norm_type)


def norm_apply(params, x: torch.Tensor, cfg, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32 (with the f32 ``scale``) and cast back to x's dtype."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"]
    else:  # layernorm / nonparametric
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm_type == "layernorm":
            y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """SwiGLU, or the plain 2-matrix gelu MLP (``jax.nn.gelu``'s default tanh
    approximation)."""
    if cfg.mlp_type == "swiglu":
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        return (F.silu(g) * u) @ params["w_down"]
    if cfg.mlp_type == "gelu":
        return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]
    raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported yet")


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half, not interleaved)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: [..., S] int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # [dh/2]
    ang = positions[..., None].float() * freqs              # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed_apply(params, x: torch.Tensor, *, tied_table=None) -> torch.Tensor:
    table = tied_table if tied_table is not None else params["table"]
    return x @ table.T
