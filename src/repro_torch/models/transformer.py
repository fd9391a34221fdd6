"""Decoder stacks: the dense, MoE and SSM block kinds, and the hybrid stack.

Parameters are L-stacked like the JAX package's scanned stacks; a Python
loop over the layer axis replaces ``lax.scan``.  The hybrid (zamba2) stack
runs blocks of ``hybrid_attn_every`` Mamba layers with the weight-shared
dense block applied after each block.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.core.offload import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mlp_apply, norm_apply, norm_init,
                                       normal_stack)


def _stacked_norm(cfg, d: int, L: int, device) -> dict:
    return {k: v.expand(L, d).clone() for k, v in norm_init(cfg, d, device).items()}


def init_stack(gen: torch.Generator, cfg, dtype, device, kind: str,
               n_layers: int) -> Dict[str, Any]:
    """L-stacked block params at the JAX package's init scales: kind
    ``"dense"`` (attention + MLP), ``"moe"`` (attention + MoE) or ``"ssm"``
    (a Mamba mixer)."""
    d, f, L = cfg.d_model, cfg.d_ff, n_layers
    if kind == "ssm":
        return {"ln1": _stacked_norm(cfg, d, L, device),
                "mamba": ssm_mod.mamba_init(gen, cfg, dtype, device, L)}
    if kind not in ("dense", "moe"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if cfg.mlp_type not in ("swiglu", "gelu"):
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported yet")
    stack = {"ln1": _stacked_norm(cfg, d, L, device),
             "attn": attn.attn_init(gen, cfg, dtype, device, L),
             "ln2": _stacked_norm(cfg, d, L, device)}
    if kind == "moe":
        stack["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, L)
        return stack
    mlp = {}                  # gelu: the plain 2-matrix MLP, no gate
    if cfg.mlp_type == "swiglu":
        mlp["w_gate"] = normal_stack(gen, (L, d, f), 1.0 / math.sqrt(d), dtype, device)
    mlp["w_up"] = normal_stack(gen, (L, d, f), 1.0 / math.sqrt(d), dtype, device)
    mlp["w_down"] = normal_stack(gen, (L, f, d), 1.0 / math.sqrt(f), dtype, device)
    stack["mlp"] = mlp
    return stack


def layer_slice(tree, i):
    """Layer ``i`` (an int or a slice) of an L-stacked tree of dicts and
    tuples (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(layer_slice(v, i) for v in tree)
    return tree[i]


def block_apply(params, x, cfg, *, kind: str, mode: str, positions,
                cache=None, cache_index=None, causal: bool = True,
                use_kernels: bool = False):
    """One block: returns (x, new_cache, aux) where new_cache = {"self": kv}
    (attention kinds) or (conv_state, ssm_state) (``"ssm"``), and aux is the
    MoE router's aux loss (the float 0.0 for the other kinds, which spares
    the decode loop a launch per layer).  In decode the layer's cache slice
    is updated in place."""
    if kind == "ssm":
        h = norm_apply(params["ln1"], x, cfg)
        y, new_state = ssm_mod.mamba_apply(
            params["mamba"], h, cfg, state=cache,
            mode="decode" if mode == "decode" else "full",
            use_kernels=use_kernels)
        if mode == "decode":
            for dst, src in zip(cache, new_state):
                dst.copy_(src)
            new_state = cache
        return x + y, new_state, 0.0
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
    return x, tree_map(lambda *ts: torch.stack(ts), *collected), aux


def hybrid_apply(params, x, cfg, *, mode: str, positions, caches=None,
                 cache_index=None, use_kernels: bool = False):
    """Zamba2-style: nb blocks of k Mamba layers + the shared dense block.

    params: {"backbone": L-stacked Mamba layers, "shared": one dense block}.
    caches (decode): {"backbone": (conv, ssm) L-stacked, "shared": {"self":
    nb-stacked kv}}, updated in place and returned; prefill returns fresh
    caches of that layout."""
    k, L = cfg.hybrid_attn_every, cfg.num_layers
    if L % k:
        raise ValueError(f"hybrid stack: {L} layers is not a multiple of "
                         f"hybrid_attn_every={k}")
    decode = mode == "decode"
    bb_new, sh_new = [], []
    for j in range(L // k):
        layers = slice(j * k, (j + 1) * k)
        x, bc, _ = stack_apply(
            layer_slice(params["backbone"], layers), x, cfg, kind="ssm",
            mode=mode, positions=positions,
            caches=layer_slice(caches["backbone"], layers) if decode else None,
            cache_index=cache_index, use_kernels=use_kernels)
        x, sc, _ = block_apply(
            params["shared"], x, cfg, kind="dense", mode=mode,
            positions=positions,
            cache=layer_slice(caches["shared"], j) if decode else None,
            cache_index=cache_index, use_kernels=use_kernels)
        bb_new.append(bc)
        sh_new.append(sc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if decode:
        return x, caches, aux
    return x, {"backbone": tree_map(lambda *ts: torch.cat(ts), *bb_new),
               "shared": tree_map(lambda *ts: torch.stack(ts), *sh_new)}, aux


def _num_layers(stacked) -> int:
    """The leading (layer) axis of the first tensor leaf: every block kind
    has one, whatever its keys."""
    while isinstance(stacked, dict):
        stacked = next(v for v in stacked.values() if not isinstance(v, dict) or v)
    return stacked.shape[0]
