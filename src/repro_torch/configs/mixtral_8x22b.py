"""Mixtral 8x22B [arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) per-expert d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention (4096).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="[arXiv:2401.04088]",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
))
