"""A DeepSeek-V3-style decoder (Moonlight-16B-A3B): the benchmark's weights
in the served layout, the plain float32 reference, the model's operations
per request, and the work formulas of its attention kernels.

The reference is plain PyTorch, after the published ``deepseek_v3``
modeling code: pre-norm RMSNorm blocks; multi-head latent attention
without a q LoRA (q = h Wq split into a part without rope and a rope part;
[c, k_pe] = h Wkv_a, c RMS-normed; [k_nope, v] = c Wkv_b per head; k_pe
shared by the heads; causal softmax over q = [q_nope, q_pe] and k =
[k_nope, k_pe] at scale 1/sqrt(qk_nope + qk_rope)); the first
``first_k_dense_replace`` layers a SwiGLU of ``intermediate_size``, the
rest an MoE layer: sigmoid scores of a float32 router, the
``num_experts_per_tok`` experts of highest score + ``e_score_correction_bias``
chosen, their unbiased scores normalised and scaled by
``routed_scaling_factor``, each expert a SwiGLU of ``moe_intermediate_size``
run over exactly the tokens that chose it (no capacity, nothing dropped),
plus the shared experts as one SwiGLU of ``n_shared_experts`` times that
width; a final RMSNorm and an untied LM head.  It takes the benchmark's
bf16 weights, upcasts one layer at a time to float32 and computes in
float32 with TF32 off, attention in its expanded form (the program's
decode absorbs the key expansion into the query; the two agree in exact
arithmetic).  ``control=True`` rounds both inputs of every matrix product
to fp8 (e4m3, one scale a tensor), the precision below the configuration's
bf16.

Departures from the published code, each shared with the program:
* rope rotates the two halves of the 64 rope columns, where the modeling
  code rotates interleaved pairs: a fixed permutation of those columns of
  ``Wq`` and ``Wkv_a``, which random weights do not see;
* the latent RMSNorm's eps is 1e-6 (the modeling code's default for
  ``kv_a_layernorm``; the configuration's ``rms_norm_eps`` 1e-5 is every
  other norm's), and every norm is computed in float32;
* ``n_group`` and ``topk_group`` are 1, so the grouped selection of
  ``noaux_tc`` is the plain top-k written here;
* the weights are seeded draws.  Each residual branch's output
  projection (``o_proj``, every ``down_proj``) is scaled by
  1/sqrt(2 x layers), and each layer's routed experts are drawn as in
  sparse upcycling: one parent SwiGLU, and each expert sqrt(1 - a^2)
  times it plus a = 0.1 times a draw of its own.  With independent
  experts at unit-gain branches a routing choice that bf16 rounding flips
  moves a token's hidden state so far, and each flip flips more in later
  layers, that at 27 layers the bf16 program's logits lie as far from this
  reference as the fp8 control's, and no limit on the gap tells the two
  apart.  ``e_score_correction_bias`` is N(0, 0.1^2), large enough against
  the scores' spread that leaving it out changes most tokens' choices.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.families import common

LATENT_EPS = 1e-6        # kv_a_layernorm's eps
BIAS_SCALE = 0.1         # e_score_correction_bias ~ N(0, BIAS_SCALE^2)
EXPERT_OWN = 0.1         # an expert's own share of its draw (upcycling)


def make_params(cfg, seed: int, device) -> Dict:
    """The served weights from ``seed``, one draw a leaf, on ``device``:
    the layout of ``repro_torch.models.model.init_params`` for an
    ``MLAConfig`` (blocks {"dense": the leading dense layers, "moe": the
    rest}, each L-stacked)."""
    g = common.generator(seed, device)
    w = common.Draw(g, device, cfg.torch_dtype)
    D, H, V = cfg.hidden_size, cfg.num_attention_heads, cfg.vocab_size
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    k = cfg.first_k_dense_replace
    E, F = cfg.n_routed_experts, cfg.moe_intermediate_size
    Fs, Fd = F * cfg.n_shared_experts, cfg.intermediate_size
    res = 1 / math.sqrt(2 * cfg.num_hidden_layers)    # a branch's output

    def attn(L):
        return {"wq": w.normal((L, D, H, dn + dr), 1 / math.sqrt(D)),
                "wkv_a": w.normal((L, D, r + dr), 1 / math.sqrt(D)),
                "kv_norm": w.norm((L, r), "rmsnorm"),
                "wkv_b": w.normal((L, r, H, dn + dv), 1 / math.sqrt(r)),
                "wo": w.normal((L, H, dv, D), res / math.sqrt(H * dv))}

    def swiglu(lead, width, own=1.0):
        """SwiGLU weights [*lead, ...]; with ``own`` < 1 the second lead
        axis (the experts) shares a parent drawn once."""
        out = {}
        for name, shape, scale in (
                ("w_gate", (D, width), 1 / math.sqrt(D)),
                ("w_up", (D, width), 1 / math.sqrt(D)),
                ("w_down", (width, D), res / math.sqrt(width))):
            out[name] = w.normal((*lead, *shape), own * scale)
            if own < 1:
                out[name].add_(w.normal((lead[0], 1, *shape),
                                        math.sqrt(1 - own * own) * scale))
        return out

    def block(L, ffn):
        return {"ln1": w.norm((L, D), "rmsnorm"), "attn": attn(L),
                "ln2": w.norm((L, D), "rmsnorm"), **ffn}

    n = cfg.num_hidden_layers - k
    blocks = {}
    if k:
        blocks["dense"] = block(k, {"mlp": swiglu((k,), Fd)})
    if n:
        moe = {"router": w.normal((n, D, E), 1 / math.sqrt(D), torch.float32),
               "router_bias": w.normal((n, E), BIAS_SCALE, torch.float32),
               **swiglu((n, E), F, EXPERT_OWN), "shared": swiglu((n,), Fs)}
        blocks["moe"] = block(n, {"moe": moe})
    params = {"embed": {"table": w.normal((V, D), 0.02)},
              "final_norm": w.norm((D,), "rmsnorm"), "blocks": blocks}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"table": w.normal((V, D), 0.02)}
    return params


def _attn_params(cfg) -> int:
    D, H = cfg.hidden_size, cfg.num_attention_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    return D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D


def request_flops(cfg, prompt_len: int, n_new: int) -> float:
    """A request's model operations, attention expanded: the prompt
    through every layer and the LM head at its last position, then
    ``n_new - 1`` decode steps (the first token comes from the prompt's
    logits), each through every layer and the LM head.  A token's matrix
    products: the attention projections, then the dense SwiGLU or the
    router, the experts it chose and the shared experts; attention
    2 H (dn + dr + dv) operations a key attended."""
    D, L, k = cfg.hidden_size, cfg.num_hidden_layers, cfg.first_k_dense_replace
    F, E = cfg.moe_intermediate_size, cfg.n_routed_experts
    attn_p = _attn_params(cfg)
    dense = attn_p + 3 * D * cfg.intermediate_size
    moe = attn_p + D * E + 3 * D * F * (cfg.num_experts_per_tok
                                        + cfg.n_shared_experts)
    per_token = 2 * (k * dense + (L - k) * moe)
    attn = 2 * cfg.num_attention_heads * (cfg.qk_nope_head_dim
                                          + cfg.qk_rope_head_dim
                                          + cfg.v_head_dim)
    head = 2 * cfg.vocab_size * D
    P, steps = prompt_len, n_new - 1
    keys = steps * P + steps * (steps + 1) // 2     # P + j keys at step j
    return float(P * per_token + L * attn * P * (P + 1) // 2 + head
                 + steps * per_token + L * attn * keys + steps * head)


def mla_decode_cost(B: int, H: int, width: int, v_dim: int, rows: int,
                    esize: int) -> Dict[str, float]:
    """A frozen copy of the port's ``kernels/costs.py:mla_decode_attention``:
    one MLA decode call over ``rows`` latent rows summed over its ``B``
    slots, each row read once (its first ``v_dim`` values are V), the
    absorbed q [B,H,width] read and out [B,H,v_dim] written, the int32
    lengths read; q . row and p . v at 2 operations a multiply-add."""
    n_bytes = rows * width * esize + B * H * (width + v_dim) * esize + 4 * B
    return {"flops": 2 * H * rows * (width + v_dim), "bytes": n_bytes}


def prefill_attention_cost(P: int, H: int, dh: int, dv: int,
                           esize: int) -> Dict[str, float]:
    """A frozen copy of the port's ``kernels/costs.py:prefill_attention``
    for one causal prompt of ``P`` tokens (B = 1, as many kv heads as
    heads, no window): q . k (width ``dh``) and p . v (width ``dv``) over
    the P(P + 1)/2 pairs the mask leaves, 2 operations a multiply-add; q, k
    and v read and the output written once."""
    pairs = P * (P + 1) // 2
    return {"flops": 2 * H * (dh + dv) * pairs,
            "bytes": esize * 2 * P * H * (dh + dv)}


# ---------------------------------------------------------------------------
def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x [T, h, d] at positions 0..T-1, the two halves of d rotated."""
    T, d = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, scale: float):
    """Causal attention of one sequence: q, k [T, H, dqk]; v [T, H, dv]."""
    T, H, _ = q.shape
    out = q.new_empty((T, H, v.shape[-1]))
    hide = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    for h0 in range(0, H, 8):           # 8 heads of [T, T] scores at a time
        hs = slice(h0, h0 + 8)
        s = torch.einsum("qhd,khd->hqk", q[:, hs], k[:, hs]) * scale
        s.masked_fill_(hide, -math.inf)
        out[:, hs] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:, hs])
    return out


def _swiglu(h, p, mm):
    return mm(torch.nn.functional.silu(mm(h, p["w_gate"])) * mm(h, p["w_up"]),
              p["w_down"])


def _mla(x, p, cfg, mm):
    T = x.shape[0]
    H, r = cfg.num_attention_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = mm(x, p["wq"].reshape(x.shape[1], -1)).view(T, H, dn + dr)
    c, k_pe = mm(x, p["wkv_a"]).split([r, dr], dim=-1)
    c = _rms(c, p["kv_norm"]["scale"], LATENT_EPS)
    k_nope, v = mm(c, p["wkv_b"].reshape(r, -1)).view(T, H, dn + dv) \
        .split([dn, dv], dim=-1)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], cfg.rope_theta)], dim=-1)
    k_pe = _rope(k_pe[:, None, :], cfg.rope_theta).expand(T, H, dr)
    o = _attend(q, torch.cat([k_nope, k_pe], dim=-1), v,
                1.0 / math.sqrt(dn + dr))
    return mm(o.reshape(T, H * dv), p["wo"].reshape(H * dv, -1))


def _moe(h, p, cfg, mm):
    """The routed experts over exactly the tokens that chose each, plus the
    shared experts."""
    scores = torch.sigmoid(mm(h, p["router"]))
    chosen = torch.topk(scores + p["router_bias"], cfg.num_experts_per_tok,
                        dim=-1).indices
    w = scores.gather(-1, chosen)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    y = _swiglu(h, p["shared"], mm)
    for e in range(cfg.n_routed_experts):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if len(tok):
            expert = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
            y.index_add_(0, tok, w[tok, slot, None] * _swiglu(h[tok], expert,
                                                              mm))
    return y


def logits(params, cfg, seqs: List[torch.Tensor], want: List[torch.Tensor],
           *, control: bool = False) -> List[torch.Tensor]:
    """The float32 logits [len(want[i]), V] of each token sequence
    ``seqs[i]`` at its positions ``want[i]``."""
    with common.plain_float32():
        return _logits(params, cfg, seqs, want, control)


def _logits(params, cfg, seqs, want, control):
    mm = common.matmul(control)
    eps = cfg.rms_norm_eps
    xs = [params["embed"]["table"][s].float() for s in seqs]
    for name, ffn in (("dense", "mlp"), ("moe", "moe")):
        stack = params["blocks"].get(name)
        if stack is None:
            continue
        for layer in range(stack["ln1"]["scale"].shape[0]):
            p = common.layer(stack, layer)
            for i, x in enumerate(xs):
                x = x + _mla(_rms(x, p["ln1"]["scale"], eps), p["attn"], cfg,
                             mm)
                h = _rms(x, p["ln2"]["scale"], eps)
                xs[i] = x + (_moe(h, p["moe"], cfg, mm) if ffn == "moe"
                             else _swiglu(h, p["mlp"], mm))
            del p
    fn = params["final_norm"]
    table = (params["embed"] if cfg.tie_word_embeddings
             else params["lm_head"])["table"]
    return common.head(xs, want, table,
                       lambda x: _rms(x, fn["scale"], eps), mm)
