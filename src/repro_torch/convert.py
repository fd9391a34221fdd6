"""Hand numpy trees of the JAX package's params and caches to the port.

The caller turns a JAX pytree into numpy first
(``jax.tree.map(np.asarray, tree)``), so this module never sees JAX.  Keys
and layouts are the same in both packages (L-stacked leaves such as
``blocks.attn.wq [L,d,H,dh]``; caches ``{"self": {"k","v"}}`` as
``[L,B,S,Hkv,dh]``).  bf16 leaves arrive as ``ml_dtypes.bfloat16``, which
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
    return _leaf(tree, dev)


def params_from_numpy(tree: Any, cfg, device: DeviceLike = None) -> Any:
    """JAX params (as numpy) -> the port's params, checked against ``cfg``."""
    params = tree_from_numpy(tree, device)
    table = params["embed"]["table"]
    wq = params["blocks"]["attn"]["wq"]
    want = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim)
    if tuple(table.shape) != (cfg.vocab_size, cfg.d_model) or tuple(wq.shape) != want:
        raise ValueError(f"params do not match {cfg.name}: embed "
                         f"{tuple(table.shape)}, wq {tuple(wq.shape)} (want "
                         f"{(cfg.vocab_size, cfg.d_model)}, {want})")
    return params


def cache_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """JAX decode cache (as numpy) -> the port's cache."""
    return tree_from_numpy(tree, device)
