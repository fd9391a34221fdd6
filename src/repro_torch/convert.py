"""Hand numpy trees of the JAX package's params and caches to the port.

The caller turns a JAX pytree into numpy first
(``jax.tree.map(np.asarray, tree)``), so this module never sees JAX.  Keys
and layouts are the same in both packages (L-stacked leaves such as
``blocks.attn.wq [L,d,H,dh]``; caches ``{"self": {"k","v"}}`` as
``[L,B,S,Hkv,dh]``; an SSM cache is the tuple ``(conv, ssm)``, which stays a
tuple).  bf16 leaves arrive as ``ml_dtypes.bfloat16``, which
torch cannot read, so they go through float32 and are cast back: exact,
since every bf16 value is a float32 value.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    # a writable copy: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a)).to(device)


def tree_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_from_numpy(v, dev) for v in tree)
    return _leaf(tree, dev)


def _mamba_want(m, cfg, L: int) -> dict:
    """(tensor, expected shape) of the L-stacked Mamba leaves; raises if a
    leaf that JAX keeps in f32 is not f32."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    want = {"in_proj": (m["in_proj"], (L, d, 2 * di)),
            "conv_w": (m["conv_w"], (L, cfg.ssm_conv, di)),
            "out_proj": (m["out_proj"], (L, di, d))}
    if cfg.mamba_version == 1:
        r = cfg.ssm_dt_rank
        want.update(x_proj=(m["x_proj"], (L, di, r + 2 * n)),
                    dt_proj=(m["dt_proj"], (L, r, di)),
                    A_log=(m["A_log"], (L, di, n)),
                    D=(m["D"], (L, di)),
                    dt_bias=(m["dt_bias"], (L, di)))
    else:
        H = di // cfg.ssm_head_dim
        want.update(bc_proj=(m["bc_proj"], (L, di, 2 * n)),
                    dt_proj=(m["dt_proj"], (L, di, H)),
                    A_log=(m["A_log"], (L, H)),
                    D=(m["D"], (L, H)),
                    dt_bias=(m["dt_bias"], (L, H)))
    for name in ("A_log", "D", "dt_bias"):
        if m[name].dtype != torch.float32:
            raise ValueError(f"params do not match {cfg.name}: {name} dtype "
                             f"{m[name].dtype}, expected float32")
    return want


def params_from_numpy(tree: Any, cfg, device: DeviceLike = None) -> Any:
    """JAX params (as numpy) -> the port's params, checked against ``cfg``."""
    params = tree_from_numpy(tree, device)
    L, d, f, E = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    blocks = params["blocks"]
    want = {"embed": (params["embed"]["table"], (cfg.vocab_size, d))}
    if cfg.family in ("ssm", "hybrid"):
        hybrid = cfg.family == "hybrid"
        if hybrid != ("shared" in blocks and "backbone" in blocks):
            raise ValueError(f"params do not match {cfg.name}: a hybrid stack "
                             "has a backbone and a shared block, an SSM stack "
                             "neither")
        backbone = blocks["backbone"] if hybrid else blocks
        if "mamba" not in backbone:
            raise ValueError(f"params do not match {cfg.name}: no Mamba blocks")
        want.update(_mamba_want(backbone["mamba"], cfg, L))
        if cfg.family == "hybrid":
            attn, mlp = blocks["shared"]["attn"], blocks["shared"]["mlp"]
            want.update(shared_wq=(attn["wq"], (d, cfg.num_heads, cfg.head_dim)),
                        shared_w_up=(mlp["w_up"], (d, f)),
                        shared_w_down=(mlp["w_down"], (f, d)))
    else:
        want["wq"] = (blocks["attn"]["wq"], (L, d, cfg.num_heads, cfg.head_dim))
    if E:
        moe = blocks.get("moe")
        if moe is None:
            raise ValueError(f"params do not match {cfg.name}: no MoE blocks")
        want.update(router=(moe["router"], (L, d, E)),
                    w_gate=(moe["w_gate"], (L, E, d, f)),
                    w_up=(moe["w_up"], (L, E, d, f)),
                    w_down=(moe["w_down"], (L, E, f, d)))
        if moe["router"].dtype != torch.float32:
            raise ValueError(f"params do not match {cfg.name}: router dtype "
                             f"{moe['router'].dtype}, expected float32")
        if ("shared" in moe) != bool(cfg.num_shared_experts):
            raise ValueError(f"params do not match {cfg.name}: shared expert "
                             f"{'present' if 'shared' in moe else 'missing'} "
                             f"with num_shared_experts={cfg.num_shared_experts}")
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            want.update(shared_w_gate=(moe["shared"]["w_gate"], (L, d, fs)),
                        shared_w_up=(moe["shared"]["w_up"], (L, d, fs)),
                        shared_w_down=(moe["shared"]["w_down"], (L, fs, d)))
    bad = {k: (tuple(t.shape), shape) for k, (t, shape) in want.items()
           if tuple(t.shape) != shape}
    if bad:
        raise ValueError(f"params do not match {cfg.name}: "
                         + ", ".join(f"{k} {got} (want {w})"
                                     for k, (got, w) in bad.items()))
    return params


def cache_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """JAX decode cache (as numpy) -> the port's cache."""
    return tree_from_numpy(tree, device)
