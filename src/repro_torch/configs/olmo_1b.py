"""OLMo-1B [arXiv:2402.00838].

16L d_model=2048 16H (kv=16, MHA) d_ff=8192 vocab=50304; non-parametric
LayerNorm (no learned scale/bias), SwiGLU, rope, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    family="dense",
    source="[arXiv:2402.00838]",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparametric",
    mlp_type="swiglu",
    tie_embeddings=True,
))
