"""Moonlight-16B-A3B as published [hf:moonshotai/Moonlight-16B-A3B,
config.json, model_type deepseek_v3].

27L d_model=2048, 16 heads of multi-head latent attention without a q LoRA
(q 2048 -> 16 x (128 + 64); kv_a 2048 -> 512 latent + 64 rope, RMSNorm on
the latent; kv_b 512 -> 16 x (128 + 128)), layer 0 dense SwiGLU 11264,
layers 1-26 MoE: 64 routed SwiGLU experts of 1408, top-6 by sigmoid score
plus a selection-only bias (noaux_tc, one group), normalised and scaled by
2.446, plus 2 shared experts; vocab 163840 untied, RoPE theta 50,000,
RMSNorm eps 1e-5.  ``moonshot-v1-16b-a3b`` is the JAX package's stand-in
under the same model's name (48 MHA layers, softmax routing).
"""
from repro_torch.configs.base import MLAConfig, register

CONFIG = register(MLAConfig(
    name="moonlight-16b-a3b",
    family="moe",
    source="[hf:moonshotai/Moonlight-16B-A3B]",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    rope_theta=50_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    dense_d_ff=11264,
    routed_scaling=2.446,
))
