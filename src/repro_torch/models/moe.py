"""Mixture-of-Experts layer: top-k router + capacity-bounded sort dispatch.

The JAX package's ``repro/models/moe.py`` global-index path
(``_moe_global``), line for line in what decides which tokens are kept and
what they sum to: sort the (token, expert) choices by expert id, scatter the
kept ones into an ``[E, C, D]`` capacity buffer, run the experts' SwiGLU
FFN over the buffer, gather back, weight by the gates and sum over the k
choices.  The expert FFN goes through ``ops.grouped_ffn``: the hand-written
CUDA kernel on the card, its plain version elsewhere.

On a mesh ``moe_apply`` takes the JAX package's ``_moe_shardmap`` path, as
JAX's does: every rank routes its (batch shard of) tokens with the whole
router -- held cut as JAX's ``param_spec`` places it (on its experts, or
on D) and gathered over "model" once a layer, as the shard_map's ``P()``
takes it (``collectives.gather_partial``: each rank's gradient is its
slice) -- and dispatches them locally (``local_dispatch_ffn``) into its own
experts -- E / msize of them (expert-parallel), or all E at a 1/msize slice
of each one's hidden width (``f_parallel``, when the experts do not divide
the "model" axis) -- and one all_reduce over "model" merges the partial
outputs.  The capacity is the shard's (from its own token count), and the
aux loss is averaged over the batch axes when the batch is split -- except
in training, where each rank's aux is its own term of the loss and the
train step's mean over the batch axes averages it (the same loss and
gradients as JAX's pmean).  In training ``xt`` and the gate values enter
this rank's experts through ``collectives.enter_partial`` and the merged
output is ``reduce_partial``, so autograd sums their gradients over
"model"; the experts run through the differentiable ``ops.grouped_ffn``.

Returns the layer output plus the router aux (load-balance) loss term of
Shazeer et al. / Switch.

A config whose ``routing`` is "sigmoid_bias" (DeepSeek-V3's ``noaux_tc``
gate with one group: an ``MLAConfig``) routes by :func:`route_biased`:
sigmoid scores, the choice made on score + a per-expert bias, the weights
the unbiased scores of the choices, normalised and scaled by
``routed_scaling``, and no token dropped.  Where :func:`sorted_route`
takes the call (a prefill on the card: bf16, no gradient, at least
``SORTED_ROWS_PER_EXPERT`` routed rows an expert on average), the layer's
T·K choices, sorted by expert, run as one ``ops.grouped_ffn_sorted`` over
the ``[T·K, D]`` rows and per-expert offsets: each expert's weights read
once, nothing zero-filled.  Elsewhere (decode, a gradient, f32, the CPU)
the capacity dispatch runs over the tokens in chunks of at most
``DROPLESS_TOKENS``, each expert's buffer holding all of a chunk's tokens
(an expert takes a token at most once), so the buffers are sized from the
shapes alone; ``counts`` tells ``grouped_ffn`` the rows in use.  The
sorted route builds its offsets on the device and adds no host sync.  No
aux loss (the gate has none).  One device only.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tracing
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_ffn import sorted_refusal
from repro_torch.models.layers import mlp_apply, normal_stack


def moe_init(gen: torch.Generator, cfg, dtype, device, n_layers: int) -> dict:
    """L-stacked MoE params at the JAX package's init scales: the router in
    f32, the experts' SwiGLU weights and (``num_shared_experts > 0``) one
    shared SwiGLU MLP of width ``d_ff * num_shared_experts``."""
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.num_experts, n_layers
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": normal_stack(gen, (L, d, e), s_in, torch.float32, device),
         **({"router_bias": torch.zeros((L, e), device=device)}
            if cfg.routing == "sigmoid_bias" else {}),
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


# a dropless layer's tokens a dispatch: its buffers [E, 2048, D] (537 MB in
# bf16 at D 2048, E 64), the output alike and the 4-byte workspace
# [E, 2048, F] (738 MB at F 1408)
DROPLESS_TOKENS = 2048
# routed rows an expert (T·K / E) from which a dropless layer takes the
# sorted route.  On the card it read faster than the capacity route at
# every size swept, 1.5 to 672 rows an expert (PERF.md §6); the decode step,
# at most 64 slots (6 rows an expert at E 64, K 6), keeps the capacity
# kernel, and 12 is the first swept size above it (a 128-token prefill)
SORTED_ROWS_PER_EXPERT = 12


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


def sort_choices(expert_ids: torch.Tensor, E: int):
    """The [T,K] choices flattened and sorted by expert, stably: (sort_idx
    [T*K], sorted_ids [T*K], counts [E], the choices of each expert)."""
    flat_ids = expert_ids.reshape(-1)
    # jnp.argsort is stable; torch.argsort is not unless asked.  The order
    # decides which tokens overflow the capacity (keep = pos < C).
    sort_idx = torch.argsort(flat_ids, stable=True)
    # bincount(minlength=E) without bincount's host sync on the card
    counts = torch.zeros((E,), dtype=torch.long, device=flat_ids.device) \
        .index_add_(0, flat_ids, torch.ones_like(flat_ids))
    return sort_idx, flat_ids[sort_idx], counts


def dispatch(expert_ids: torch.Tensor, E: int, C: int):
    """Sort-based dispatch of the [T,K] choices into E buckets of capacity C.
    Returns (sort_idx, sorted_ids, pos, keep, src_token), each [T*K], and
    the per-expert choice counts [E] (kept or not)."""
    K = expert_ids.shape[1]
    sort_idx, sorted_ids, counts = sort_choices(expert_ids, E)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(sorted_ids.numel(), device=sorted_ids.device) \
        - offsets[sorted_ids]
    keep = pos < C
    src_token = sort_idx // K
    return sort_idx, sorted_ids, pos, keep, src_token, counts


def sorted_route(xt: torch.Tensor, w_gate: torch.Tensor, cfg,
                 use_kernels: bool) -> bool:
    """Whether a layer's tokens xt [T,D] take the sorted route: a dropless
    layer with kernels on, ``grouped_ffn_sorted``'s kernel taking the call
    (bf16, no gradient, on the card: ``sorted_refusal``), and at least
    ``SORTED_ROWS_PER_EXPERT`` routed rows an expert on average: a
    prefill, while a decode step's few rows an expert keep the capacity
    kernel."""
    return (cfg.routing == "sigmoid_bias" and bool(use_kernels)
            and xt.shape[0] * cfg.experts_per_token
            >= SORTED_ROWS_PER_EXPERT * cfg.num_experts
            and sorted_refusal(xt, w_gate) is None)


def moe_apply(params, x: torch.Tensor, cfg, *, use_kernels: bool = False,
              shard=None, train: bool = False):
    """x: [B,S,D] -> (y [B,S,D] in x's dtype, aux scalar f32).  On a mesh
    (``shard``) x is this rank's batch rows and the experts are this rank's
    slice (``launch.mesh.shard_params``); ``train``: the aux stays this
    rank's own term (module docstring)."""
    dropless = cfg.routing == "sigmoid_bias"
    if dropless and shard is not None:
        raise ValueError("the dropless sigmoid-routed MoE layer runs on one "
                         "device, not on a mesh")
    if shard is not None:
        params = dict(params, router=_whole_router(params["router"], cfg,
                                                   shard.mesh))
    if shard is not None and "model" in shard.mesh.shape:
        msize = shard.mesh.shape["model"]
        if cfg.num_experts % msize == 0 and cfg.num_experts >= msize:
            return moe_sharded(params, x, cfg, shard, use_kernels=use_kernels,
                               train=train)              # expert-parallel
        if cfg.d_ff % msize == 0 and cfg.d_ff >= msize:
            return moe_sharded(params, x, cfg, shard, f_parallel=True,
                               use_kernels=use_kernels,
                               train=train)              # TP within experts
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    with tracing.span("moe.route"):
        if dropless:
            gate_vals, expert_ids = route_biased(xt, params["router"],
                                                 params["router_bias"], cfg)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            gate_vals, expert_ids, aux, _ = route(xt, params["router"], cfg)
    with tracing.span("moe.experts"):
        if sorted_route(xt, params["w_gate"], cfg, use_kernels):
            y = _sorted_experts(params, xt, gate_vals, expert_ids, cfg)
        else:
            y = _capacity_experts(params, xt, gate_vals, expert_ids, cfg,
                                  T, dropless, use_kernels)
    if "shared" in params:
        with tracing.span("moe.shared"):
            y = y + mlp_apply(params["shared"], xt, cfg).to(x.dtype)
    return y.reshape(B, S, D), aux


def _capacity_experts(params, xt, gate_vals, expert_ids, cfg, T: int,
                      dropless: bool, use_kernels: bool) -> torch.Tensor:
    """The routed experts through ``[E, C, D]`` capacity buffers: the whole
    batch at the capacity factor's C, or a dropless layer's tokens in
    chunks of ``DROPLESS_TOKENS``, each chunk's C its own token count."""
    step = min(T, DROPLESS_TOKENS) if dropless else T
    parts = [_routed_experts(params, xt[i:i + step], gate_vals[i:i + step],
                             expert_ids[i:i + step], cfg,
                             min(step, T - i) if dropless
                             else _capacity(T, cfg), use_kernels=use_kernels)
             for i in range(0, T, step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _sorted_experts(params, xt: torch.Tensor, gate_vals: torch.Tensor,
                    expert_ids: torch.Tensor, cfg) -> torch.Tensor:
    """The gate-weighted sum of the routed experts' outputs [T,D]: the T·K
    choices sorted by expert into rows xs [T·K, D] with per-expert offsets
    [E+1] (built on the device), one ``grouped_ffn_sorted`` over them, then
    the rows un-sorted, weighted by the gates in xt's dtype and summed over
    K, as ``_routed_experts`` combines."""
    T, D = xt.shape
    K = expert_ids.shape[1]
    sort_idx, _, counts = sort_choices(expert_ids, cfg.num_experts)
    offsets = torch.zeros((cfg.num_experts + 1,), dtype=torch.int32,
                          device=xt.device)
    offsets[1:] = torch.cumsum(counts, 0)
    ys = ops.grouped_ffn_sorted(xt[sort_idx // K], params["w_gate"],
                                params["w_up"], params["w_down"], offsets)
    unsorted = torch.empty_like(ys)
    unsorted[sort_idx] = ys            # sort_idx is a permutation
    unsorted.mul_(gate_vals.reshape(T * K)[:, None].to(xt.dtype))
    return unsorted.reshape(T, K, D).sum(dim=1)


def _routed_experts(params, xt: torch.Tensor, gate_vals: torch.Tensor,
                   expert_ids: torch.Tensor, cfg, C: int, *,
                   use_kernels: bool = False) -> torch.Tensor:
    """The gate-weighted sum of the routed experts' outputs [T,D] for the
    tokens xt [T,D] and their choices [T,K]: sorted by expert into an
    ``[E, C, D]`` buffer, a choice past its expert's C rows dropped (none
    when C >= T)."""
    T, D = xt.shape
    K = expert_ids.shape[1]
    sort_idx, sorted_ids, pos, keep, src_token, counts = dispatch(
        expert_ids, cfg.num_experts, C)
    slot = torch.where(keep, pos, 0)

    # a dropped choice adds zeros into slot 0 of its expert, as in JAX; rows
    # at or past min(count, C) stay zero, so the FFN may skip them
    buf = torch.zeros((cfg.num_experts, C, D), dtype=xt.dtype,
                      device=xt.device)
    buf.index_put_((sorted_ids, slot),
                   xt[src_token].masked_fill(~keep[:, None], 0),
                   accumulate=True)

    out_buf = ops.grouped_ffn(buf, params["w_gate"], params["w_up"],
                              params["w_down"],
                              counts=counts.clamp(max=C).to(torch.int32),
                              use_kernels=use_kernels)

    # combine: gather back, unsort, weight by the gates, sum over K
    gathered = out_buf[sorted_ids, slot].masked_fill(~keep[:, None], 0)
    unsorted = torch.zeros((T * K, D), dtype=xt.dtype, device=xt.device)
    unsorted[sort_idx] = gathered
    w = gate_vals.reshape(T * K)[:, None].to(xt.dtype)
    return (unsorted * w).reshape(T, K, D).sum(dim=1)


def route_biased(xt: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
                 cfg):
    """xt: [T,D] -> (weights [T,K] f32, expert_ids [T,K]): the K experts
    of highest sigmoid score + ``bias``, weighted by their unbiased
    scores, normalised to sum 1 and scaled by ``routed_scaling``."""
    scores = torch.sigmoid(xt.float() @ router)
    expert_ids = torch.topk(scores + bias, cfg.experts_per_token, dim=-1,
                            sorted=True).indices
    w = scores.gather(-1, expert_ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling
    return w, expert_ids


def _whole_router(router: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The router [D, E] from this rank's cut of it (``launch.mesh.
    shard_params``: E over "model", or D where the axis does not divide
    E), gathered on the dim it is cut on; the whole router as it is."""
    dims = [i for i, n in enumerate((cfg.d_model, cfg.num_experts))
            if router.shape[i] != n]
    if not dims:
        return router
    blocks = coll.gather_partial(router, mesh, ("model",))   # [m, ...]
    return torch.movedim(blocks, 0, dims[0]).flatten(dims[0], dims[0] + 1)


def local_dispatch_ffn(xt, gate_vals, expert_ids, wg, wu, wd, e0: int,
                       E_loc: int, C_loc: int, *, use_kernels: bool = False):
    """Sort-based dispatch + expert FFN over the LOCAL experts [e0, e0 +
    E_loc) (the JAX package's ``_local_dispatch_ffn``).  xt: [T,D]; the
    routing [T,K] is global.  Returns [T,D] holding only these experts'
    gate-weighted contributions.  A choice of another rank's expert, or one
    past the capacity C_loc, lands in a spare expert row that is cut off."""
    T, D = xt.shape
    K = expert_ids.shape[1]
    rel = expert_ids.reshape(-1) - e0                      # [T*K]
    mine = (rel >= 0) & (rel < E_loc)
    bins = torch.where(mine, rel, E_loc)
    sort_idx = torch.argsort(bins, stable=True)
    sorted_bins = bins[sort_idx]
    counts = torch.zeros((E_loc + 1,), dtype=torch.long, device=xt.device) \
        .index_add_(0, bins, torch.ones_like(bins))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=xt.device) - offsets[sorted_bins]
    keep = (pos < C_loc) & (sorted_bins < E_loc)
    src_token = sort_idx // K
    e_idx = torch.where(keep, sorted_bins, E_loc)
    slot = torch.where(keep, pos, 0)

    # kept (expert, slot) pairs are distinct; the rest write zeros into the
    # spare row E_loc
    buf = torch.zeros((E_loc + 1, C_loc, D), dtype=xt.dtype, device=xt.device)
    buf[e_idx, slot] = xt[src_token].masked_fill(~keep[:, None], 0)
    out_buf = ops.grouped_ffn(buf[:E_loc], wg, wu, wd,
                              counts=counts[:E_loc].clamp(max=C_loc)
                              .to(torch.int32),
                              use_kernels=use_kernels)
    gathered = out_buf[torch.where(keep, sorted_bins, 0), slot] \
        .masked_fill(~keep[:, None], 0)
    w = gate_vals.reshape(T * K)[sort_idx][:, None].to(xt.dtype)
    unsorted = torch.zeros((T * K, D), dtype=xt.dtype, device=xt.device)
    unsorted[sort_idx] = gathered * w
    return unsorted.reshape(T, K, D).sum(dim=1)


def moe_sharded(params, x: torch.Tensor, cfg, shard, *,
                f_parallel: bool = False, use_kernels: bool = False,
                train: bool = False):
    """The JAX package's ``_moe_shardmap`` on this rank: x [B_loc,S,D] (its
    batch rows) -> (y [B_loc,S,D], aux).  Expert-parallel: this rank holds
    experts [i E/msize, (i + 1) E/msize); ``f_parallel``: all E experts at
    a 1/msize slice of the hidden width.  One all_reduce over "model" adds
    the partial outputs (and the shared experts' partial MLP, when their
    hidden width is split too).  ``train``: no mean of the aux over the
    batch axes (the train step takes it)."""
    mesh = shard.mesh
    B, S, D = x.shape
    E = cfg.num_experts
    msize = mesh.shape["model"]
    E_loc = E if f_parallel else E // msize
    T = B * S
    C_loc = _capacity(T, cfg)
    xt = x.reshape(T, D)
    gate_vals, expert_ids, aux, _ = route(xt, params["router"], cfg)
    if shard.batch_axes and not train:
        # the aux loss is a per-shard mean: average it over the batch shards
        aux = coll.all_reduce(aux.reshape(1), mesh, shard.batch_axes)[0] \
            / mesh.axes_size(shard.batch_axes)
    e0 = 0 if f_parallel else mesh.axis_index("model") * E_loc
    xt_loc = coll.enter_partial(xt, mesh, ("model",))
    y = local_dispatch_ffn(xt_loc, coll.enter_partial(gate_vals, mesh, ("model",)),
                           expert_ids, params["w_gate"], params["w_up"],
                           params["w_down"], e0, E_loc, C_loc,
                           use_kernels=use_kernels)
    shared = params.get("shared")
    split_shared = shared is not None and \
        shared["w_down"].shape[-2] != cfg.d_ff * cfg.num_shared_experts
    if split_shared:
        y = y + mlp_apply(shared, xt_loc, cfg).to(x.dtype)
    y = coll.reduce_partial(y, mesh, ("model",))
    if shared is not None and not split_shared:
        y = y + mlp_apply(shared, xt, cfg).to(x.dtype)
    return y.reshape(B, S, D), aux
