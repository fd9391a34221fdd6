"""Top-level model: init / cache / forward (dense, MoE, SSM and hybrid).

Public API (the JAX package's ``repro/models/model.py`` counterpart)
------------------------------------------------------------------
init_params(cfg, seed, device=None)          -> params (dict of tensors)
init_cache(cfg, batch, seq_len, dtype, device) -> the JAX cache layout
forward(params, cfg, batch, mode=...)        -> ModelOutputs

``batch`` is a dict:
  prefill: {"tokens": [B,S]}
  decode:  {"token": [B,1], "cache": ..., "cache_index": scalar or [B]}
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_apply, norm_apply, norm_init, unembed_apply


@dataclass
class ModelOutputs:
    logits: Any           # [B,S,V] (prefill: the last position only, S = 1)
    aux_loss: Any         # scalar router aux (0 for a dense model)
    cache: Any = None     # decode/prefill caches


def _kind(cfg) -> str:
    if cfg.family in ("audio", "vlm") or cfg.frontend or cfg.encoder_layers:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.family in ("ssm", "hybrid"):
        return cfg.family
    if cfg.family == "moe" or cfg.num_experts:
        return "moe"
    return "dense"


def init_params(cfg, seed: int = 0, *, device: DeviceLike = None) -> Dict[str, Any]:
    """Random params from ``seed`` at the JAX package's init scales (the
    numbers differ from JAX's: a test hands JAX params over with
    ``repro_torch.convert``).  Runs on the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    kind = _kind(cfg)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device=dev) * 0.02).to(dtype)
    params: Dict[str, Any] = {
        "embed": {"table": table},
        "final_norm": norm_init(cfg, cfg.d_model, dev),
    }
    if kind == "hybrid":
        shared = tfm.init_stack(gen, cfg, dtype, dev, "dense", 1)
        params["blocks"] = {
            "backbone": tfm.init_stack(gen, cfg, dtype, dev, "ssm", cfg.num_layers),
            "shared": tfm.layer_slice(shared, 0)}
    else:
        params["blocks"] = tfm.init_stack(gen, cfg, dtype, dev, kind,
                                          cfg.num_layers)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": (torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen, device=dev) * 0.02
        ).to(dtype)}
    return params


def init_cache(cfg, batch: int, seq_len: int, dtype=None, *, device) -> Any:
    """Decode caches sized for seq_len positions, in the JAX layout:
    {"self": {"k","v"}} of [L,B,S,Hkv,dh] (dense, MoE); a tuple (conv
    [L,B,W-1,di] in ``dtype``, ssm [L,B,di,N] or [L,B,H,P,N] in f32) (SSM);
    {"backbone": that tuple, "shared": {"self": kv of nb layers}} (hybrid)."""
    kind = _kind(cfg)
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    dtype = dtype or cfg.torch_dtype
    L = cfg.num_layers

    def kv(n_layers):
        shape = (n_layers, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def ssm_states(n_layers):
        conv, ssm = ssm_mod.mamba_state_shapes(cfg, batch)
        return (torch.zeros((n_layers, *conv), dtype=dtype, device=device),
                torch.zeros((n_layers, *ssm), dtype=torch.float32, device=device))

    if kind == "ssm":
        return ssm_states(L)
    if kind == "hybrid":
        return {"backbone": ssm_states(L),
                "shared": {"self": kv(L // cfg.hybrid_attn_every)}}
    return {"self": kv(L)}


def _logits(params, cfg, x):
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed_apply(
        params.get("lm_head"), x,
        tied_table=params["embed"]["table"] if cfg.tie_embeddings else None)


def _stack(kind: str):
    """The stack function for ``kind``: the hybrid stack, or
    ``stack_apply`` with the block kind bound."""
    if kind == "hybrid":
        return tfm.hybrid_apply
    return functools.partial(tfm.stack_apply, kind=kind)


def forward(params, cfg, batch, *, mode: str = "prefill",
            use_kernels: bool = False) -> ModelOutputs:
    kind = _kind(cfg)
    if mode == "prefill":
        tokens = batch["tokens"]
        x = embed_apply(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x, caches, aux = _stack(kind)(params["blocks"], x, cfg, mode="prefill",
                                      positions=positions,
                                      use_kernels=use_kernels)
        # only the last position's logits are needed
        return ModelOutputs(logits=_logits(params, cfg, x[:, -1:]),
                            aux_loss=aux, cache=caches)

    if mode != "decode":
        raise NotImplementedError(f"forward mode {mode!r} is not ported yet")
    token, cache, idx = batch["token"], batch["cache"], batch["cache_index"]
    x = embed_apply(params["embed"], token)
    if torch.is_tensor(idx) and idx.dim():   # per-slot cache indices [B]
        positions = idx.to(torch.int32)[:, None]
    else:
        positions = torch.as_tensor(idx, dtype=torch.int32,
                                    device=token.device).reshape(1)
    x, caches, aux = _stack(kind)(params["blocks"], x, cfg, mode="decode",
                                  positions=positions, caches=cache,
                                  cache_index=idx, use_kernels=use_kernels)
    return ModelOutputs(logits=_logits(params, cfg, x), aux_loss=aux,
                        cache=caches)
