"""A dense decoder with grouped-query attention (nemotron-4-15b): the
benchmark's weights in the served layout, the plain float32 reference,
and the model's operations per request.

The reference is plain PyTorch: pre-norm LayerNorm blocks, rotary
positions on split halves, causal softmax attention with each kv head
shared by ``H / Hkv`` query heads, a squared-ReLU MLP, a final LayerNorm
and an untied LM head.  It takes the benchmark's bf16 weights, upcasts
one layer at a time to float32 and computes in float32 with TF32 off.
``control=True`` rounds both inputs of every matrix product to fp8
(e4m3, one scale a tensor), the precision below the configuration's bf16.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.families import common


def make_params(cfg, seed: int, device) -> Dict:
    """The served weights from ``seed``, one draw a leaf, on ``device``."""
    g = common.generator(seed, device)
    L, D, H, Hkv, dh, F, V = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
                              cfg.vocab_size)
    w = common.Draw(g, device, cfg.torch_dtype)
    params = {
        "embed": {"table": w.normal((V, D), 0.02)},
        "final_norm": w.norm((D,), cfg.norm_type),
        "blocks": {
            "ln1": w.norm((L, D), cfg.norm_type),
            "attn": {"wq": w.normal((L, D, H, dh), 1 / math.sqrt(D)),
                     "wk": w.normal((L, D, Hkv, dh), 1 / math.sqrt(D)),
                     "wv": w.normal((L, D, Hkv, dh), 1 / math.sqrt(D)),
                     "wo": w.normal((L, H, dh, D), 1 / math.sqrt(H * dh))},
            "ln2": w.norm((L, D), cfg.norm_type),
            "mlp": {"w_up": w.normal((L, D, F), 1 / math.sqrt(D)),
                    "w_down": w.normal((L, F, D), 1 / math.sqrt(F))},
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": w.normal((V, D), 0.02)}
    return params


def matmul_params(cfg) -> int:
    """Weights a token multiplies through in one layer."""
    D, H, Hkv, dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    return D * H * dh + 2 * D * Hkv * dh + H * dh * D + 2 * D * F


def request_flops(cfg, prompt_len: int, n_new: int) -> float:
    """A request's model operations: the prompt through every layer and
    the LM head at its last position, then ``n_new - 1`` decode steps
    (the first token comes from the prompt's logits), each through every
    layer and the LM head; attention 4 H dh operations a key attended."""
    L, P = cfg.num_layers, prompt_len
    per_layer = 2 * matmul_params(cfg)
    attn = 4 * cfg.num_heads * cfg.head_dim
    head = 2 * cfg.vocab_size * cfg.d_model
    prefill = L * (P * per_layer + attn * P * (P + 1) // 2) + head
    steps = n_new - 1
    keys = steps * P + steps * (steps + 1) // 2     # P + j keys at step j
    return float(prefill + L * (steps * per_layer + attn * keys)
                 + steps * head)


# ---------------------------------------------------------------------------
def _layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _rope(x, theta: float):
    """x [T, h, dh] at positions 0..T-1, the two halves of dh rotated."""
    T, dh = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, group: int):
    """Causal attention of one sequence: q [T, H, dh]; k, v [T, Hkv, dh]."""
    T, H, dh = q.shape
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    for h0 in range(0, H, 8):           # 8 heads of [T, T] scores at a time
        hs = slice(h0, h0 + 8)
        s = torch.einsum("qhd,khd->hqk", q[:, hs], k[:, hs]) / math.sqrt(dh)
        s.masked_fill_(torch.ones(T, T, dtype=torch.bool,
                                  device=q.device).triu(1), -math.inf)
        out[:, hs] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:, hs])
    return out


def logits(params, cfg, seqs: List[torch.Tensor], want: List[torch.Tensor],
           *, control: bool = False) -> List[torch.Tensor]:
    """The float32 logits [len(want[i]), V] of each token sequence
    ``seqs[i]`` at its positions ``want[i]``."""
    with common.plain_float32():
        return _logits(params, cfg, seqs, want, control)


def _logits(params, cfg, seqs, want, control):
    mm = common.matmul(control)
    blocks = params["blocks"]
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xs = [params["embed"]["table"][s].float() for s in seqs]
    for layer in range(cfg.num_layers):
        p = common.layer(blocks, layer)
        for i, x in enumerate(xs):
            T = x.shape[0]
            h = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
            q = mm(h, p["attn"]["wq"].reshape(cfg.d_model, -1)).view(T, H, dh)
            k = mm(h, p["attn"]["wk"].reshape(cfg.d_model, -1)).view(T, Hkv, dh)
            v = mm(h, p["attn"]["wv"].reshape(cfg.d_model, -1)).view(T, Hkv, dh)
            o = _attend(_rope(q, cfg.rope_theta), _rope(k, cfg.rope_theta), v,
                        H // Hkv)
            x = x + mm(o.reshape(T, H * dh), p["attn"]["wo"].reshape(H * dh, -1))
            h = _layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"])
            x = x + mm(torch.relu(mm(h, p["mlp"]["w_up"])).square(),
                       p["mlp"]["w_down"])
            xs[i] = x
        del p
    fn = params["final_norm"]
    table = (params["embed"] if cfg.tie_embeddings else params["lm_head"])["table"]
    return common.head(xs, want, table,
                       lambda x: _layernorm(x, fn["scale"], fn["bias"]), mm)
