"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family scaling].

94L d_model=4096 64H (GQA kv=4, head_dim=128, qk-norm) per-expert d_ff=1536,
vocab=151936, MoE 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="[hf:Qwen/Qwen3-30B-A3B]",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                # per-expert FFN width
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
))
