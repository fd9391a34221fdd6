"""Decoder and encoder stacks: the dense, MoE, SSM, encoder and
cross-attending decoder block kinds, the hybrid stack, and an
``MLAConfig``'s stack (:func:`mla_stack_apply`: its leading dense layers,
then its MoE layers, each with multi-head latent attention).

Parameters are L-stacked like the JAX package's scanned stacks; a Python
loop over the layer axis replaces ``lax.scan``.  Mode "train" runs the
prefill's arithmetic and keeps no cache; ``remat`` recomputes each layer's
activations in the backward pass (``torch.utils.checkpoint``, where JAX
wraps its scan body in ``jax.checkpoint``).  The hybrid (zamba2) stack
runs blocks of ``hybrid_attn_every`` Mamba layers with the weight-shared
dense block applied after each block.  The audio model's encoder blocks are
non-causal dense blocks; its decoder blocks (``"decoder_x"``) add a
cross-attention sublayer over the encoder's output between self-attention
and the MLP.  On a mesh (``shard``) every block kind runs this rank's
block: attention (self and cross) as ``attention.attn_apply`` says, the
MLP as column (``w_gate``/``w_up``) and row (``w_down``) slices of its
hidden width meeting in one all_reduce, the MoE layer as
``moe.moe_apply`` says, a Mamba mixer as ``ssm.mamba_apply`` says; the
hybrid stack hands the shard to its backbone and its shared block.  In
training the MLP's input enters the split as ``collectives.enter_partial``
and its output is ``reduce_partial``, so autograd sums the input's
gradient over "model"; with FSDP-cut params (``fsdp``: the tree of each
leaf's FSDP dim) each layer's leaves are gathered over the batch axes
right before the layer runs (``sharding.gather_fsdp``; under ``remat``
inside the recomputed function, so the gather runs again in the backward
and at most one layer is whole at a time), the hybrid stack's shared block
once for all its applications.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.offload import tree_map
from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mlp_apply, norm_apply, norm_init,
                                       normal_stack)


ATTENTION_KINDS = ("dense", "moe", "encoder", "decoder_x")
MLA_KINDS = ("mla_dense", "mla_moe")    # an MLAConfig's layers


def _stacked_norm(cfg, d: int, L: int, device) -> dict:
    return {k: v.expand(L, d).clone() for k, v in norm_init(cfg, d, device).items()}


def init_stack(gen: torch.Generator, cfg, dtype, device, kind: str,
               n_layers: int) -> Dict[str, Any]:
    """L-stacked block params at the JAX package's init scales: kind
    ``"dense"`` or ``"encoder"`` (attention + MLP), ``"decoder_x"``
    (attention + cross-attention + MLP), ``"moe"`` (attention + MoE),
    ``"ssm"`` (a Mamba mixer), or an ``MLAConfig``'s ``"mla_dense"`` (latent
    attention + a SwiGLU of width ``dense_d_ff``) and ``"mla_moe"`` (latent
    attention + the dropless MoE)."""
    d, f, L = cfg.d_model, cfg.d_ff, n_layers
    if kind == "ssm":
        return {"ln1": _stacked_norm(cfg, d, L, device),
                "mamba": ssm_mod.mamba_init(gen, cfg, dtype, device, L)}
    if kind in MLA_KINDS:
        stack = {"ln1": _stacked_norm(cfg, d, L, device),
                 "attn": attn.mla_init(gen, cfg, dtype, device, L),
                 "ln2": _stacked_norm(cfg, d, L, device)}
        if kind == "mla_moe":
            stack["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, L)
            return stack
        f = cfg.dense_d_ff
    else:
        if kind not in ATTENTION_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        stack = {"ln1": _stacked_norm(cfg, d, L, device),
                 "attn": attn.attn_init(gen, cfg, dtype, device, L)}
        if kind == "decoder_x":
            stack["lnx"] = _stacked_norm(cfg, d, L, device)
            stack["xattn"] = attn.attn_init(gen, cfg, dtype, device, L,
                                            cross=True)
        stack["ln2"] = _stacked_norm(cfg, d, L, device)
        if kind == "moe":
            stack["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, L)
            return stack
    mlp = {}                  # squared_relu / gelu: 2 matrices, no gate
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


def layer_chunks(params, k: int) -> list:
    """L-stacked params (a tree of dicts) as L/k trees of k-layer views, one
    ``split`` per leaf.  Its backward joins the chunks' gradients once;
    slicing the stack once per layer would give each slice's gradient a
    zero tensor the size of the whole stack, summed over the layers (O(L^2)
    in a backward pass)."""
    def split(t):
        if isinstance(t, dict):
            return {key: split(v) for key, v in t.items()}
        return t.split(k)

    def pick(t, j):
        if isinstance(t, dict):
            return {key: pick(v, j) for key, v in t.items()}
        return t[j]

    parts = split(params)
    return [pick(parts, j) for j in range(-(-_num_layers(params) // k))]


def block_apply(params, x, cfg, *, kind: str, mode: str, positions,
                cache=None, cache_index=None, enc_out=None, enc_positions=None,
                causal: bool = True, use_kernels: bool = False, shard=None):
    """One block: returns (x, new_cache, aux) where new_cache = {"self": kv}
    (attention kinds; ``"decoder_x"`` adds {"cross": kv} over ``enc_out``,
    an ``"encoder"`` block returns None) or (conv_state, ssm_state)
    (``"ssm"``), and aux is the MoE router's aux loss (the float 0.0 for the
    other kinds, which spares the decode loop a launch per layer).  In
    decode the layer's cache slice is updated in place; the cross cache is
    only read.  Mode "train" returns no cache and writes nothing in place."""
    if kind in MLA_KINDS:
        return _mla_block(params, x, cfg, kind=kind, mode=mode,
                          positions=positions, cache=cache,
                          cache_index=cache_index, use_kernels=use_kernels)
    if kind == "ssm":
        if mode == "resume":
            raise ValueError("SSM states fold the whole prefix; resume is "
                             "attention-only")
        h = norm_apply(params["ln1"], x, cfg)
        y, new_state = ssm_mod.mamba_apply(
            params["mamba"], h, cfg, state=cache,
            mode="decode" if mode == "decode" else "full",
            use_kernels=use_kernels, shard=shard)
        if mode == "decode":
            for dst, src in zip(cache, new_state):
                dst.copy_(src)
            new_state = cache
        return x + y, None if mode == "train" else new_state, 0.0
    if kind not in ATTENTION_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    h = norm_apply(params["ln1"], x, cfg)
    if mode == "decode":
        y, new_kv = attn.attn_apply(params["attn"], h, cfg, positions=positions,
                                    mode="decode", cache=cache["self"],
                                    cache_index=cache_index,
                                    use_kernels=use_kernels, shard=shard)
    else:
        # mode "resume": x holds only the tail rows and cache["self"] the
        # cached prefix K/V they attend over; the returned K/V are
        # full-length (the cold-prefill layout)
        prefix = (cache["self"]["k"], cache["self"]["v"]) \
            if mode == "resume" else None
        y, kv = attn.attn_apply(params["attn"], h, cfg, positions=positions,
                                mode="full", causal=causal, prefix_kv=prefix,
                                use_kernels=use_kernels, shard=shard)
        new_kv = {"k": kv[0], "v": kv[1]}
    x = x + y
    new_cache = None if kind == "encoder" or mode == "train" \
        else {"self": new_kv}
    if kind == "decoder_x":
        h = norm_apply(params["lnx"], x, cfg)
        if mode == "decode":
            y, _ = attn.attn_apply(params["xattn"], h, cfg, positions=positions,
                                   mode="decode", cache=cache["cross"],
                                   cross=True, use_kernels=use_kernels,
                                   shard=shard)
            new_cache["cross"] = cache["cross"]
        else:
            y, xkv = attn.attn_apply(params["xattn"], h, cfg, positions=positions,
                                     mode="full", kv_x=enc_out,
                                     kv_positions=enc_positions,
                                     use_kernels=use_kernels, shard=shard)
            if new_cache is not None:
                new_cache["cross"] = {"k": xkv[0], "v": xkv[1]}
        x = x + y
    h = norm_apply(params["ln2"], x, cfg)
    if kind == "moe":
        y, aux = moe_mod.moe_apply(params["moe"], h, cfg,
                                   use_kernels=use_kernels, shard=shard,
                                   train=mode == "train")
    elif shard is not None and params["mlp"]["w_down"].shape[-2] != cfg.d_ff:
        # the hidden width split over "model": partial outputs
        h = coll.enter_partial(h, shard.mesh, ("model",))
        y = coll.reduce_partial(mlp_apply(params["mlp"], h, cfg), shard.mesh,
                                ("model",))
        aux = 0.0
    else:
        y, aux = mlp_apply(params["mlp"], h, cfg), 0.0
    return x + y, new_cache, aux


def _mla_block(params, x, cfg, *, kind: str, mode: str, positions, cache,
               cache_index, use_kernels: bool):
    """One layer of an ``MLAConfig``: latent attention (its cache
    {"self": {"latent"}}), then the dense SwiGLU or the dropless MoE."""
    h = norm_apply(params["ln1"], x, cfg)
    y, new_rows = attn.mla_apply(
        params["attn"], h, cfg, positions=positions,
        mode="decode" if mode == "decode" else "full",
        cache=cache["self"] if mode == "decode" else None,
        cache_index=cache_index, use_kernels=use_kernels)
    x = x + y
    h = norm_apply(params["ln2"], x, cfg)
    if kind == "mla_moe":
        y, aux = moe_mod.moe_apply(params["moe"], h, cfg,
                                   use_kernels=use_kernels,
                                   train=mode == "train")
    else:
        y, aux = mlp_apply(params["mlp"], h, cfg), 0.0
    return x + y, None if mode == "train" else {"self": new_rows}, aux


def _gathered_block(lp, x, cfg, fsdp=None, **kw):
    """``block_apply`` on one layer's params, its FSDP slices (``fsdp``:
    their dims on the L-stacked leaves) gathered first."""
    if fsdp is not None:
        lp = sharding.gather_fsdp(lp, fsdp, kw["shard"].mesh, layer=True)
    return block_apply(lp, x, cfg, **kw)


def _block(lp, x, cfg, remat: bool, fsdp=None, **kw):
    """One layer (``_gathered_block``), its activations, and its FSDP
    gathers, recomputed in the backward pass under ``remat``."""
    if remat:
        return checkpoint(_gathered_block, lp, x, cfg, fsdp,
                          use_reentrant=False, **kw)
    return _gathered_block(lp, x, cfg, fsdp, **kw)


def stack_apply(stacked, x, cfg, *, kind: str, mode: str, positions,
                caches=None, cache_index=None, enc_out=None, enc_positions=None,
                causal: bool = True, remat: bool = False,
                use_kernels: bool = False, shard=None, fsdp=None):
    """Returns (x, caches, aux summed over the layers).  Mode "decode"
    updates the L-stacked ``caches`` in place and returns them; mode
    "prefill" returns freshly stacked [L, ...] caches, and so does mode
    "resume", whose ``caches`` hold the cached prefix rows.  An encoder
    stack, and every stack in mode "train", keeps no cache (None).
    ``fsdp``: the FSDP dims of ``stacked``'s leaves (training on a mesh)."""
    collected = []
    aux = 0.0              # a tensor once an MoE block adds its term
    for i, layer in enumerate(layer_chunks(stacked, 1)):
        lcache = layer_slice(caches, i) if mode in ("decode", "resume") else None
        x, new_cache, a = _block(
            layer_slice(layer, 0), x, cfg, remat, kind=kind, mode=mode,
            positions=positions, cache=lcache, cache_index=cache_index,
            enc_out=enc_out, enc_positions=enc_positions, causal=causal,
            use_kernels=use_kernels, shard=shard, fsdp=fsdp)
        aux = aux + a
        collected.append(new_cache)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "decode":
        return x, caches, aux
    if kind == "encoder" or mode == "train":
        return x, None, aux
    return x, tree_map(lambda *ts: torch.stack(ts), *collected), aux


def hybrid_apply(params, x, cfg, *, mode: str, positions, caches=None,
                 cache_index=None, remat: bool = False,
                 use_kernels: bool = False, shard=None, fsdp=None):
    """Zamba2-style: nb blocks of k Mamba layers + the shared dense block.

    params: {"backbone": L-stacked Mamba layers, "shared": one dense block}.
    caches (decode): {"backbone": (conv, ssm) L-stacked, "shared": {"self":
    nb-stacked kv}}, updated in place and returned; prefill returns fresh
    caches of that layout, train none.  ``shard``: this rank's block on a
    mesh, for both; ``fsdp``: {"backbone", "shared"} FSDP dims (training on
    a mesh)."""
    k, L = cfg.hybrid_attn_every, cfg.num_layers
    if L % k:
        raise ValueError(f"hybrid stack: {L} layers is not a multiple of "
                         f"hybrid_attn_every={k}")
    decode = mode == "decode"
    shared = params["shared"]
    if fsdp is not None:
        shared = sharding.gather_fsdp(shared, fsdp["shared"], shard.mesh)
    bb_new, sh_new = [], []
    for j, block in enumerate(layer_chunks(params["backbone"], k)):
        layers = slice(j * k, (j + 1) * k)
        x, bc, _ = stack_apply(
            block, x, cfg, kind="ssm",
            mode=mode, positions=positions,
            caches=layer_slice(caches["backbone"], layers) if decode else None,
            cache_index=cache_index, remat=remat, use_kernels=use_kernels,
            shard=shard, fsdp=None if fsdp is None else fsdp["backbone"])
        x, sc, _ = _block(
            shared, x, cfg, remat, kind="dense", mode=mode,
            positions=positions,
            cache=layer_slice(caches["shared"], j) if decode else None,
            cache_index=cache_index, use_kernels=use_kernels, shard=shard)
        bb_new.append(bc)
        sh_new.append(sc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if decode:
        return x, caches, aux
    if mode == "train":
        return x, None, aux
    return x, {"backbone": tree_map(lambda *ts: torch.cat(ts), *bb_new),
               "shared": tree_map(lambda *ts: torch.stack(ts), *sh_new)}, aux


def mla_stack_apply(params, x, cfg, *, mode: str, positions, caches=None,
                    cache_index=None, remat: bool = False,
                    use_kernels: bool = False):
    """An ``MLAConfig``'s stack: params {"dense": the first_k_dense layers,
    "moe": the rest}, each L-stacked; caches {"self": {"latent": [L, B, S,
    r + dr]}} over all L layers.  Returns (x, caches, aux) as
    :func:`stack_apply` does: mode "decode" updates ``caches`` in place,
    "prefill" returns fresh ones, "train" none."""
    lat = caches["self"]["latent"] if mode == "decode" else None
    k = cfg.first_k_dense
    parts, aux = [], 0.0
    for name, kind, layers in (("dense", "mla_dense", slice(0, k)),
                               ("moe", "mla_moe", slice(k, None))):
        if name not in params:
            continue
        sub = None if lat is None else {"self": {"latent": lat[layers]}}
        x, c, a = stack_apply(params[name], x, cfg, kind=kind, mode=mode,
                              positions=positions, caches=sub,
                              cache_index=cache_index, remat=remat,
                              use_kernels=use_kernels)
        parts.append(c)
        aux = aux + a
    if mode == "decode":
        return x, caches, aux
    if mode == "train":
        return x, None, aux
    return x, {"self": {"latent": torch.cat(
        [c["self"]["latent"] for c in parts])}}, aux


def _num_layers(stacked) -> int:
    """The leading (layer) axis of the first tensor leaf: every block kind
    has one, whatever its keys."""
    while isinstance(stacked, dict):
        stacked = next(v for v in stacked.values() if not isinstance(v, dict) or v)
    return stacked.shape[0]
