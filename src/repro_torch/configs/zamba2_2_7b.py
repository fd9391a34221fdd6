"""Zamba2-2.7B [arXiv:2411.15242].

54L d_model=2560; Mamba-2 backbone (ssm_state=64) + a weight-SHARED
attention block (32H, kv=32) invoked every 6 layers; d_ff=10240 for the
shared block's MLP; vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="[arXiv:2411.15242]",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    mamba_version=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    norm_type="rmsnorm",
    mlp_type="gelu",
))
