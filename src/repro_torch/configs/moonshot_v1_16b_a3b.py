"""Moonlight-16B-A3B (moonshot-v1-16b-a3b) [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (kv=16 i.e. MHA) per-expert d_ff=1408 vocab=163840,
MoE 64 experts top-6 + 2 shared experts (DeepSeek-V3-style).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="[hf:moonshotai/Moonlight-16B-A3B]",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    rope_theta=50_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
))
