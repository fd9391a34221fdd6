"""Decoder stack (dense kind only in this port so far).

Parameters are L-stacked like the JAX package's scanned stacks; a Python
loop over the layer axis replaces ``lax.scan``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, norm_apply, norm_init


def _stacked_norm(cfg, d: int, L: int, device) -> dict:
    return {k: v.expand(L, d).clone() for k, v in norm_init(cfg, d, device).items()}


def init_stack(gen: torch.Generator, cfg, dtype, device, kind: str,
               n_layers: int) -> Dict[str, Any]:
    """L-stacked block params at the JAX package's init scales."""
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported yet")
    d, f, L = cfg.d_model, cfg.d_ff, n_layers

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    mlp = {"w_gate": normal((L, d, f), 1.0 / math.sqrt(d)),
           "w_up": normal((L, d, f), 1.0 / math.sqrt(d)),
           "w_down": normal((L, f, d), 1.0 / math.sqrt(f))}
    return {"ln1": _stacked_norm(cfg, d, L, device),
            "attn": attn.attn_init(gen, cfg, dtype, device, L),
            "ln2": _stacked_norm(cfg, d, L, device),
            "mlp": mlp}


def layer_slice(tree, i: int):
    """Layer ``i`` of an L-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def block_apply(params, x, cfg, *, kind: str, mode: str, positions,
                cache=None, cache_index=None, causal: bool = True,
                use_kernels: bool = False):
    """One block: returns (x, new_cache) where new_cache = {"self": kv}."""
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = norm_apply(params["ln1"], x, cfg)
    if mode == "decode":
        y, new_kv = attn.attn_apply(params["attn"], h, cfg, positions=positions,
                                    mode="decode", cache=cache["self"],
                                    cache_index=cache_index,
                                    use_kernels=use_kernels)
    else:
        y, kv = attn.attn_apply(params["attn"], h, cfg, positions=positions,
                                mode="full", causal=causal)
        new_kv = {"k": kv[0], "v": kv[1]}
    x = x + y
    h = norm_apply(params["ln2"], x, cfg)
    return x + mlp_apply(params["mlp"], h, cfg), {"self": new_kv}


def stack_apply(stacked, x, cfg, *, kind: str, mode: str, positions,
                caches=None, cache_index=None, causal: bool = True,
                use_kernels: bool = False):
    """mode "decode" updates the L-stacked ``caches`` in place and returns
    them; mode "prefill" returns freshly stacked [L, ...] caches."""
    collected = []
    for i in range(stacked["attn"]["wq"].shape[0]):
        lcache = layer_slice(caches, i) if mode == "decode" else None
        x, new_cache = block_apply(
            layer_slice(stacked, i), x, cfg, kind=kind, mode=mode,
            positions=positions, cache=lcache, cache_index=cache_index,
            causal=causal, use_kernels=use_kernels)
        collected.append(new_cache)
    if mode == "decode":
        return x, caches
    return x, {"self": {name: torch.stack([c["self"][name] for c in collected])
                        for name in ("k", "v")}}
