"""InternVL2-1B language backbone (Qwen2-0.5B LM) [arXiv:2404.16821].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The InternViT-300M
vision encoder + MLP projector are a STUB per the assignment: input_specs()
provides precomputed patch embeddings of shape (batch, patches, 896) which
are prepended to the text token embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="[arXiv:2404.16821]",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    frontend="vision",
    frontend_tokens=256,      # ViT patch embeddings per image (448/14 tiling)
    frontend_dim=896,
    tie_embeddings=True,
))
