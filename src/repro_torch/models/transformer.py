"""Decoder stacks: the dense and MoE block kinds.

Parameters are L-stacked like the JAX package's scanned stacks; a Python
loop over the layer axis replaces ``lax.scan``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (mlp_apply, norm_apply, norm_init,
                                       normal_stack)


def _stacked_norm(cfg, d: int, L: int, device) -> dict:
    return {k: v.expand(L, d).clone() for k, v in norm_init(cfg, d, device).items()}


def init_stack(gen: torch.Generator, cfg, dtype, device, kind: str,
               n_layers: int) -> Dict[str, Any]:
    """L-stacked block params at the JAX package's init scales: kind
    ``"dense"`` (attention + SwiGLU MLP) or ``"moe"`` (attention + MoE)."""
    if kind not in ("dense", "moe"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported yet")
    d, f, L = cfg.d_model, cfg.d_ff, n_layers
    stack = {"ln1": _stacked_norm(cfg, d, L, device),
             "attn": attn.attn_init(gen, cfg, dtype, device, L),
             "ln2": _stacked_norm(cfg, d, L, device)}
    if kind == "moe":
        stack["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, L)
        return stack
    stack["mlp"] = {
        "w_gate": normal_stack(gen, (L, d, f), 1.0 / math.sqrt(d), dtype, device),
        "w_up": normal_stack(gen, (L, d, f), 1.0 / math.sqrt(d), dtype, device),
        "w_down": normal_stack(gen, (L, f, d), 1.0 / math.sqrt(f), dtype, device)}
    return stack


def layer_slice(tree, i: int):
    """Layer ``i`` of an L-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def block_apply(params, x, cfg, *, kind: str, mode: str, positions,
                cache=None, cache_index=None, causal: bool = True,
                use_kernels: bool = False):
    """One block: returns (x, new_cache, aux) where new_cache = {"self": kv}
    and aux is the MoE router's aux loss (the float 0.0 for a dense block,
    which spares the decode loop a launch per layer)."""
    if kind not in ("dense", "moe"):
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
    if kind == "moe":
        y, aux = moe_mod.moe_apply(params["moe"], h, cfg, use_kernels=use_kernels)
    else:
        y, aux = mlp_apply(params["mlp"], h, cfg), 0.0
    return x + y, {"self": new_kv}, aux


def stack_apply(stacked, x, cfg, *, kind: str, mode: str, positions,
                caches=None, cache_index=None, causal: bool = True,
                use_kernels: bool = False):
    """Returns (x, caches, aux summed over the layers).  Mode "decode"
    updates the L-stacked ``caches`` in place and returns them; mode
    "prefill" returns freshly stacked [L, ...] caches."""
    collected = []
    aux = 0.0              # a tensor once an MoE block adds its term
    for i in range(_num_layers(stacked)):
        lcache = layer_slice(caches, i) if mode == "decode" else None
        x, new_cache, a = block_apply(
            layer_slice(stacked, i), x, cfg, kind=kind, mode=mode,
            positions=positions, cache=lcache, cache_index=cache_index,
            causal=causal, use_kernels=use_kernels)
        aux = aux + a
        collected.append(new_cache)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "decode":
        return x, caches, aux
    return x, {"self": {name: torch.stack([c["self"][name] for c in collected])
                        for name in ("k", "v")}}, aux


def _num_layers(stacked) -> int:
    """The leading (layer) axis of the first tensor leaf: every block kind
    has one, whatever its keys."""
    while isinstance(stacked, dict):
        stacked = next(v for v in stacked.values() if not isinstance(v, dict) or v)
    return stacked.shape[0]
