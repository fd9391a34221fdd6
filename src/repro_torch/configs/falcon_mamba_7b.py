"""Falcon-Mamba-7B [arXiv:2410.05355].

64L d_model=4096, attention-free Mamba-1 (ssm_state=16, expand=2 ->
d_inner=8192, conv=4), vocab=65024.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="[arXiv:2410.05355]",
    num_layers=64,
    d_model=4096,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    d_ff=0,                   # no separate MLP; mamba block only
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    mamba_version=1,
    norm_type="rmsnorm",
    tie_embeddings=True,
))
