"""Model/config registry (the port's own copy of ``repro/configs/base.py``).

Every architecture gets a module ``repro_torch/configs/<id>.py`` that builds a
:class:`ModelConfig` with the published numbers and registers it under its
id.  ``get_config(name)`` / ``list_configs()`` are the public API;
``reduced(cfg)`` derives the CPU test variant (<=2 layers, d_model<=512,
<=4 experts, float32).  :class:`MLAConfig` adds the fields of a
DeepSeek-V3-style model, which the JAX package has no twin of.
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
    # the router (``models.moe``): "softmax" is top-k of softmax scores,
    # each expert's buffer capped by ``moe_capacity_factor``.  A class
    # attribute, not a field, so the JAX twins' fields stay theirs
    routing = "softmax"
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

    @property
    def is_attention_free(self) -> bool:
        return self.num_heads == 0 and self.hybrid_attn_every == 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling (SSM / hybrid / sliding window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Total parameters N (analytic, matches ``models.model.init_params``)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A DeepSeek-V3-style decoder (``model_type`` deepseek_v3): multi-head
    latent attention over a cache of one latent row a token, the first
    ``first_k_dense`` layers dense SwiGLU of width ``dense_d_ff``, the rest
    MoE layers routed by sigmoid scores with a selection-only bias and
    dropping no token.  The inherited fields keep their meaning:
    ``num_heads`` query heads, ``d_ff`` a routed expert's width,
    ``num_shared_experts`` shared experts merged into one SwiGLU of width
    ``d_ff * num_shared_experts``; ``num_kv_heads`` and ``head_dim`` are
    unused (``moe_capacity_factor`` too: nothing is dropped).  Its
    ``routing`` "sigmoid_bias" is DeepSeek-V3's ``noaux_tc`` gate with one
    group, dropless (``models.moe.moe_apply``)."""
    kv_lora_rank: int = 0            # latent width r (RMS-normed)
    qk_nope_head_dim: int = 0        # a head's q/k width without rope
    qk_rope_head_dim: int = 0        # the rope width, k's shared by heads
    v_head_dim: int = 0
    first_k_dense: int = 0           # leading dense layers
    dense_d_ff: int = 0              # their SwiGLU width
    routed_scaling: float = 1.0      # the routed weights' factor
    routing: str = "sigmoid_bias"

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """A latent cache row: the normed latent, then the rope'd k."""
        return self.kv_lora_rank + self.qk_rope_head_dim


def is_mla(cfg) -> bool:
    return isinstance(cfg, MLAConfig)


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


def mesh_configs():
    """The registered configurations a mesh runs: all but an
    ``MLAConfig``, which runs on one device.  They are the JAX package's
    twins, which the dry run and the mesh paths cover."""
    return [n for n in list_configs() if not is_mla(_REGISTRY[n])]


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
    if is_mla(cfg):      # the latent path at widths a CPU test can run
        upd.update(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                   v_head_dim=32, head_dim=48, dense_d_ff=d_model * 2,
                   first_k_dense=min(cfg.first_k_dense, layers - 1))
    return dataclasses.replace(cfg, **upd)
