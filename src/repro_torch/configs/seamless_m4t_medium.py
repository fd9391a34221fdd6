"""SeamlessM4T-medium transformer backbone [arXiv:2308.11596].

Enc-dec: 12L encoder + 12L decoder, d_model=1024 16H (kv=16 i.e. MHA)
d_ff=4096 vocab=256206.  The speech frontend (mel-spectrogram + conv
feature extractor / w2v-BERT) is a STUB per the assignment: input_specs()
provides precomputed frame embeddings of shape (batch, frames, 1024).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="[arXiv:2308.11596]",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    norm_type="layernorm",
    mlp_type="gelu",
    frontend="audio",
    frontend_tokens=1024,     # precomputed speech-frame embeddings per request
    frontend_dim=1024,
))
