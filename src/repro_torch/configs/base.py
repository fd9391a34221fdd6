"""Model/config registry (the port's own copy of ``repro/configs/base.py``).

Every architecture gets a module ``repro_torch/configs/<id>.py`` that builds a
:class:`ModelConfig` with the published numbers and registers it under its
id.  ``get_config(name)`` / ``list_configs()`` are the public API;
``reduced(cfg)`` derives the CPU test variant (<=2 layers, d_model<=512,
<=4 experts, float32).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import torch

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                      # citation for the config numbers
    num_layers: int
    d_model: int
    num_heads: int = 0               # 0 => attention-free
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1
    ssm_head_dim: int = 64
    ssm_dt_rank: int = 0
    # --- hybrid (zamba2) ---
    hybrid_attn_every: int = 0
    # --- attention options ---
    sliding_window: int = 0          # 0 => full attention
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # --- norms / mlp ---
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparametric
    mlp_type: str = "swiglu"         # swiglu | squared_relu | gelu
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend stub (vlm / audio) ---
    frontend: str = ""
    frontend_tokens: int = 0
    frontend_dim: int = 0
    # --- numerics ---
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    kv_quant: str = ""               # "" | "int8"

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_state and not self.ssm_dt_rank:
            object.__setattr__(self, "ssm_dt_rank", -(-self.d_model // 16))

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model


# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import every sibling config module exactly once
    import importlib
    import pkgutil
    import repro_torch.configs as pkg
    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name != "base":
            importlib.import_module(f"repro_torch.configs.{m.name}")


# ---------------------------------------------------------------------------
def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """CPU test variant of the same family (<=2 layers, d_model<=512,
    <=4 experts, float32) -- field for field the JAX package's ``reduced``."""
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = 0
    if heads:
        kv = max(1, min(cfg.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
    upd = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=(d_model // heads) if heads else 0,
        d_ff=max(4, d_model * 2) if cfg.d_ff else 0,
        vocab_size=vocab,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        moe_capacity_factor=4.0 if cfg.num_experts else cfg.moe_capacity_factor,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_dt_rank=0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        hybrid_attn_every=2 if cfg.hybrid_attn_every else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_tokens=16 if cfg.frontend else 0,
        frontend_dim=d_model if cfg.frontend else 0,
        dtype="float32",
    )
    return dataclasses.replace(cfg, **upd)
