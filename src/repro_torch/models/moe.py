"""Mixture-of-Experts layer: top-k router + capacity-bounded sort dispatch.

The JAX package's ``repro/models/moe.py`` global-index path
(``_moe_global``), line for line in what decides which tokens are kept and
what they sum to: sort the (token, expert) choices by expert id, scatter the
kept ones into an ``[E, C, D]`` capacity buffer, run the experts' SwiGLU
FFN over the buffer, gather back, weight by the gates and sum over the k
choices.  The expert FFN goes through ``ops.grouped_ffn``: the hand-written
CUDA kernel on the card, its plain version elsewhere.  The expert-parallel
shard_map path waits for the multi-GPU port; ``moe_apply`` always takes the
global path, as the JAX one does without a mesh.

Returns the layer output plus the router aux (load-balance) loss term of
Shazeer et al. / Switch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import mlp_apply, normal_stack


def moe_init(gen: torch.Generator, cfg, dtype, device, n_layers: int) -> dict:
    """L-stacked MoE params at the JAX package's init scales: the router in
    f32, the experts' SwiGLU weights and (``num_shared_experts > 0``) one
    shared SwiGLU MLP of width ``d_ff * num_shared_experts``."""
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.num_experts, n_layers
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": normal_stack(gen, (L, d, e), s_in, torch.float32, device),
         "w_gate": normal_stack(gen, (L, e, d, f), s_in, dtype, device),
         "w_up": normal_stack(gen, (L, e, d, f), s_in, dtype, device),
         "w_down": normal_stack(gen, (L, e, f, d), s_out, dtype, device)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": normal_stack(gen, (L, d, fs), s_in, dtype, device),
            "w_up": normal_stack(gen, (L, d, fs), s_in, dtype, device),
            "w_down": normal_stack(gen, (L, fs, d), 1.0 / math.sqrt(fs), dtype,
                                   device)}
    return p


def _capacity(tokens: int, cfg) -> int:
    c = int(tokens * cfg.experts_per_token * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(xt: torch.Tensor, router: torch.Tensor, cfg):
    """xt: [T,D] -> (gate_vals [T,K] f32, expert_ids [T,K], aux, probs [T,E])."""
    E, K = cfg.num_experts, cfg.experts_per_token
    T = xt.shape[0]
    probs = torch.softmax(xt.float() @ router, dim=-1)
    # jax.lax.top_k breaks ties toward the lower index; torch.topk does not
    # promise an order among equal probs.  Ties between float32 softmax
    # outputs of distinct experts do not occur on real activations.
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # aux load-balance loss (Switch): density of the top-1 choice
    ones = torch.ones((T,), dtype=torch.float32, device=xt.device)
    density = torch.zeros((E,), dtype=torch.float32, device=xt.device) \
        .index_add_(0, expert_ids[:, 0], ones) / T
    aux = cfg.router_aux_loss * E * torch.sum(density * probs.mean(dim=0))
    return gate_vals, expert_ids, aux, probs


def dispatch(expert_ids: torch.Tensor, E: int, C: int):
    """Sort-based dispatch of the [T,K] choices into E buckets of capacity C.
    Returns (sort_idx, sorted_ids, pos, keep, src_token), each [T*K], and
    the per-expert choice counts [E] (kept or not)."""
    K = expert_ids.shape[1]
    flat_ids = expert_ids.reshape(-1)
    # jnp.argsort is stable; torch.argsort is not unless asked.  The order
    # decides which tokens overflow the capacity (keep = pos < C).
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort_idx]
    # bincount(minlength=E) without bincount's host sync on the card
    counts = torch.zeros((E,), dtype=torch.long, device=flat_ids.device) \
        .index_add_(0, flat_ids, torch.ones_like(flat_ids))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_ids.numel(), device=flat_ids.device) - offsets[sorted_ids]
    keep = pos < C
    src_token = sort_idx // K
    return sort_idx, sorted_ids, pos, keep, src_token, counts


def moe_apply(params, x: torch.Tensor, cfg, *, use_kernels: bool = False):
    """x: [B,S,D] -> (y [B,S,D] in x's dtype, aux scalar f32)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = _capacity(T, cfg)
    xt = x.reshape(T, D)
    gate_vals, expert_ids, aux, _ = route(xt, params["router"], cfg)
    sort_idx, sorted_ids, pos, keep, src_token, counts = dispatch(expert_ids, E, C)
    slot = torch.where(keep, pos, 0)

    # a dropped choice adds zeros into slot 0 of its expert, as in JAX; rows
    # at or past min(count, C) stay zero, so the FFN may skip them
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((sorted_ids, slot),
                   xt[src_token].masked_fill(~keep[:, None], 0),
                   accumulate=True)

    out_buf = ops.grouped_ffn(buf, params["w_gate"], params["w_up"],
                              params["w_down"],
                              counts=counts.clamp(max=C).to(torch.int32),
                              use_kernels=use_kernels)

    # combine: gather back, unsort, weight by the gates, sum over K
    gathered = out_buf[sorted_ids, slot].masked_fill(~keep[:, None], 0)
    unsorted = torch.zeros((T * K, D), dtype=x.dtype, device=x.device)
    unsorted[sort_idx] = gathered
    w = gate_vals.reshape(T * K)[:, None].to(x.dtype)
    y = (unsorted * w).reshape(T, K, D).sum(dim=1)

    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, cfg).to(x.dtype)
    return y.reshape(B, S, D), aux
