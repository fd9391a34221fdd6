"""Top-level model: init / cache / forward (dense, MoE, SSM, hybrid, and the
vlm and audio families with their stubbed frontends).

Public API (the JAX package's ``repro/models/model.py`` counterpart)
------------------------------------------------------------------
init_params(cfg, seed, device=None)          -> params (dict of tensors)
init_cache(cfg, batch, seq_len, dtype, device) -> the JAX cache layout
forward(params, cfg, batch, mode=...)        -> ModelOutputs
cross_entropy(logits, labels, mask=None, *, vocab=None)
                                             -> mean next-token NLL (f32)

``batch`` is a dict:
  train:   {"tokens": [B,S]} (+"frontend" as in prefill): logits over every
           position, the router aux loss and ``loss_mask``; no caches
  prefill: {"tokens": [B,S]} (+"frontend": [B,F,fd] for vlm/audio: the vlm
           prepends the projected patch rows, so its caches hold F+S rows;
           the audio model encodes the frames and its decoder attends over
           them), optionally "prefix": an L-stacked cache {"self": {"k","v"}}
           of [L,B,q,Hkv,dh] post-RoPE K/V for rows [0, q) (dense stacks,
           the vlm's prologue included): only the tail rows run, the
           returned cache is full-length
  decode:  {"token": [B,1], "cache": ..., "cache_index": scalar or [B]}
           (the vlm's index counts its F prologue rows)

Under ``models.sharding.activation_sharding(mesh)`` (every family,
serving modes) every rank holds ``launch.mesh.shard_params``' slice of the
params and its block of the cache (``init_cache``), takes the whole
batch's tokens, frontend embeddings and indices (replicated), computes its
own batch rows (all of them when the batch does not divide the batch axes)
and returns the whole batch's logits, gathered over the "model" axis
(vocab-parallel head) and the batch axes: every rank ends a step with the
same logits.  The tables and ``frontend_proj`` are cut as
``launch.mesh.model_cuts`` says (``shard.cuts(cfg)``): a table on its
vocab rows, or on its D columns where the axis does not divide the
vocabulary (``layers.vocab_embed`` / ``vocab_logits``); ``frontend_proj``
on its D columns, the projected patch or frame rows gathered along D, so
the vlm's prologue rows and the audio encoder's input are whole on every
rank.

In mode "train" on a mesh every family runs the rank's block of the train
step (``training.train``): ``batch`` holds the rank's rows of the global
batch (``shard``, its :class:`~repro_torch.models.sharding.RankShard`),
the logits are those rows' (no gather over the batch axes: each rank's
loss is its own term of the mean) and, where "model" cuts the LM head's
table, only this rank's block of ⌈V/m⌉ vocabulary columns
(``layers.vocab_block_logits``; ``ModelOutputs.vocab`` says where it
lies), which :func:`cross_entropy` reduces over "model" as JAX's loss
reduces its vocab-sharded logits; and the params may be FSDP-cut too
(``launch.mesh.shard_params(fsdp=True)``; ``fsdp``, the tree of each
leaf's FSDP dim, ``TrainLayout.fsdp_dims``): the top-level leaves are
gathered over the batch axes once, each layer's right before it runs.
The collectives are differentiable (``distributed/collectives.py``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.configs.base import is_mla
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed_apply, gather_cols, norm_apply,
                                       norm_init, unembed_apply,
                                       vocab_block_logits, vocab_embed,
                                       vocab_logits)


@dataclass
class ModelOutputs:
    logits: Any           # [B,S,V] (prefill: the last position only, S = 1)
    aux_loss: Any         # scalar router aux (0 for a dense model)
    cache: Any = None     # decode/prefill caches
    loss_mask: Any = None # train: [S'] bool, the positions that carry loss
    vocab: Any = None     # train on a mesh: the logits' layers.VocabBlock
                          # (None: the whole vocabulary)


def _kind(cfg) -> str:
    if is_mla(cfg):
        return "mla"
    if cfg.family in ("ssm", "hybrid"):
        return cfg.family
    if cfg.family == "moe" or cfg.num_experts:
        return "moe"
    if cfg.family == "audio":
        return "decoder_x"
    return "dense"


def init_params(cfg, seed: int = 0, *, device: DeviceLike = None) -> Dict[str, Any]:
    """Random params from ``seed`` at the JAX package's init scales (the
    numbers differ from JAX's: a test hands JAX params over with
    ``repro_torch.convert``).  Runs on the card unless ``device`` says
    otherwise; on the meta device (the dry run) the draws come from a CPU
    generator, as a generator cannot live on it, and hold no data."""
    dev = resolve_device(device)
    kind = _kind(cfg)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device=dev) * 0.02).to(dtype)
    params: Dict[str, Any] = {
        "embed": {"table": table},
        "final_norm": norm_init(cfg, cfg.d_model, dev),
    }
    if kind == "hybrid":
        shared = tfm.init_stack(gen, cfg, dtype, dev, "dense", 1)
        params["blocks"] = {
            "backbone": tfm.init_stack(gen, cfg, dtype, dev, "ssm", cfg.num_layers),
            "shared": tfm.layer_slice(shared, 0)}
    elif kind == "mla":     # the leading dense layers, then the MoE layers
        k = cfg.first_k_dense
        params["blocks"] = {
            name: tfm.init_stack(gen, cfg, dtype, dev, block, n)
            for name, block, n in (("dense", "mla_dense", k),
                                   ("moe", "mla_moe", cfg.num_layers - k))
            if n}
    else:
        params["blocks"] = tfm.init_stack(gen, cfg, dtype, dev, kind,
                                          cfg.num_layers)
    if cfg.encoder_layers:
        params["encoder"] = tfm.init_stack(gen, cfg, dtype, dev, "encoder",
                                           cfg.encoder_layers)
        params["enc_norm"] = norm_init(cfg, cfg.d_model, dev)
    if cfg.frontend:
        fd = cfg.frontend_dim or cfg.d_model
        params["frontend_proj"] = (torch.randn(
            (fd, cfg.d_model), generator=gen, device=dev) / math.sqrt(fd)
        ).to(dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": (torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen, device=dev) * 0.02
        ).to(dtype)}
    return params


def init_cache(cfg, batch: int, seq_len: int, dtype=None, *, device) -> Any:
    """Decode caches sized for seq_len positions, in the JAX layout:
    {"self": {"k","v"}} of [L,B,S,Hkv,dh] (dense, MoE, vlm); a tuple (conv
    [L,B,W-1,di] in ``dtype``, ssm [L,B,di,N] or [L,B,H,P,N] in f32) (SSM);
    {"backbone": that tuple, "shared": {"self": kv of nb layers}} (hybrid);
    the audio decoder adds {"cross": kv of F = frontend_tokens rows}.  With
    ``kv_quant="int8"`` every self K/V is int8 beside f32 ``k_scale`` /
    ``v_scale`` [L,B,S,Hkv,1]; the cross cache is never quantized.  An
    ``MLAConfig`` caches one latent row a token: {"self": {"latent":
    [L,B,S,r+dr]}}, no head axis (one device, never quantized).

    Under an active mesh only this rank's block is allocated: its batch
    rows, its kv heads (when they divide "model") and its sequence rows,
    the block :func:`cache_shard` names; a state leaf holds the rank's
    channels (Mamba-2: heads) and the cross K/V all F rows."""
    kind = _kind(cfg)
    dtype = dtype or cfg.torch_dtype
    L = cfg.num_layers
    if kind == "mla":
        _mla_one_device(cfg)
        return {"self": {"latent": torch.zeros(
            (L, batch, seq_len, cfg.latent_dim), dtype=dtype, device=device)}}
    hkv = cfg.num_kv_heads
    m = 1
    mesh = sharding.active_mesh()
    if mesh is not None:
        sh = cache_shard(cfg, batch, seq_len)
        batch, seq_len = sh.B_loc, sh.S_loc
        m = mesh.shape.get("model", 1)
        if hkv % m == 0 and hkv >= m:
            hkv //= m

    def kv(n_layers, length=seq_len, quant=True):
        shape = (n_layers, batch, length, hkv, cfg.head_dim)
        if quant and cfg.kv_quant == "int8":
            scale = shape[:-1] + (1,)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(scale, dtype=torch.float32, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v_scale": torch.zeros(scale, dtype=torch.float32, device=device)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def ssm_states(n_layers):
        conv, ssm = ssm_mod.mamba_state_shapes(cfg, batch, m)
        return (torch.zeros((n_layers, *conv), dtype=dtype, device=device),
                torch.zeros((n_layers, *ssm), dtype=torch.float32, device=device))

    if kind == "ssm":
        return ssm_states(L)
    if kind == "hybrid":
        return {"backbone": ssm_states(L),
                "shared": {"self": kv(L // cfg.hybrid_attn_every)}}
    if kind == "decoder_x":
        return {"self": kv(L), "cross": kv(L, cfg.frontend_tokens, quant=False)}
    return {"self": kv(L)}


def cache_shard(cfg, batch: int, seq_len: int):
    """The :class:`~repro_torch.models.sharding.RankShard` of a [batch,
    seq_len] decode cache on the active mesh (None off-mesh): the block
    ``init_cache`` allocates, and what a decode (``forward``'s ``shard``),
    a slot write and a splice need to find this rank's rows.  An SSM
    model's cache is states alone: no sequence to shard."""
    mesh = sharding.active_mesh()
    if mesh is None:
        return None
    _mla_one_device(cfg)
    if _kind(cfg) == "ssm":
        return sharding.rank_shard(mesh, batch)
    return sharding.rank_shard(mesh, batch, Hkv=cfg.num_kv_heads, S=seq_len)


def _mla_one_device(cfg) -> None:
    """Refuse what latent attention does not support: a mesh, an int8
    cache."""
    if not is_mla(cfg):
        return
    if sharding.active_mesh() is not None:
        raise ValueError(f"{cfg.name}: multi-head latent attention runs on "
                         "one device; meshes are not supported")
    if cfg.kv_quant:
        raise ValueError(f"{cfg.name}: the latent cache is not quantized "
                         f"(kv_quant={cfg.kv_quant!r})")


def frontend_offset(cfg) -> int:
    """Cache rows ahead of the prompt tokens: the vlm's F patch rows."""
    return cfg.frontend_tokens if cfg.family == "vlm" else 0


def _embed_inputs(params, cfg, batch, shard=None):
    """(x [B,S',D], positions [S'], loss_mask [S'] bool): the vlm prepends
    its projected patch embeddings, so S' = F + S, and its prologue rows
    ``< frontend_tokens`` carry no loss."""
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens, shard)
    if cfg.frontend and cfg.family == "vlm":
        x = torch.cat([_frontend(params, cfg, batch, shard), x], dim=1)
    positions = torch.arange(x.shape[1], device=tokens.device)
    return x, positions, positions >= frontend_offset(cfg)


def _encode(params, cfg, batch, mode: str = "prefill", remat: bool = False,
            shard=None, fsdp=None, use_kernels: bool = False):
    """The audio encoder over the stubbed frame embeddings: (enc_out
    [B,F,D], positions [F]); ``shard``: this rank's block on a mesh;
    ``fsdp``: the encoder stack's FSDP dims (training on a mesh)."""
    fe = _frontend(params, cfg, batch, shard)
    pos = torch.arange(fe.shape[1], device=fe.device)
    enc, _, _ = tfm.stack_apply(params["encoder"], fe, cfg, kind="encoder",
                                mode=mode, positions=pos, causal=False,
                                remat=remat, use_kernels=use_kernels,
                                shard=shard, fsdp=fsdp)
    return norm_apply(params["enc_norm"], enc, cfg), pos


def _frontend(params, cfg, batch, shard):
    """The stubbed frontend's embeddings projected to d_model [B,F,D]: on a
    mesh that cuts ``frontend_proj`` on its D columns, this rank's columns
    gathered along D."""
    fe = batch["frontend"].to(cfg.torch_dtype) @ params["frontend_proj"]
    if shard is not None and shard.cuts(cfg).frontend == "d":
        return gather_cols(fe, shard.mesh)
    return fe


def _head(params, cfg, x):
    """(the final-normed x, the LM head's table: the tied one when tied)."""
    table = params["embed"]["table"] if cfg.tie_embeddings \
        else params["lm_head"]["table"]
    return norm_apply(params["final_norm"], x, cfg), table


def _logits(params, cfg, x, shard=None):
    """Serving: the whole vocabulary's logits of every batch row."""
    x, table = _head(params, cfg, x)
    if shard is None:
        return unembed_apply(None, x, tied_table=table)
    cut = shard.cuts(cfg).head
    logits = vocab_logits(x, table, shard.mesh, cut=cut) if cut \
        else x @ table.T
    if shard.b_sharded:    # every rank's batch rows, in rank order
        logits = coll.gather_sum(logits, shard.mesh, shard.batch_axes) \
            .flatten(0, 1)
    return logits


def _train_logits(params, cfg, x, shard=None):
    """(logits, vocab): the rank's rows' logits; where "model" cuts the LM
    head's table only this rank's vocabulary block and its
    ``layers.VocabBlock`` (else the whole vocabulary and None)."""
    x, table = _head(params, cfg, x)
    cut = shard.cuts(cfg).head if shard is not None else None
    if cut:
        return vocab_block_logits(x, table, shard.mesh, cut=cut)
    return unembed_apply(None, x, tied_table=table), None


def _embed(params, cfg, tokens, shard):
    cut = shard.cuts(cfg).embed if shard is not None else None
    if cut:
        return vocab_embed(params["embed"]["table"], tokens, shard.mesh,
                           cut=cut)
    return embed_apply(params["embed"], tokens)


def _stack(kind: str):
    """The stack function for ``kind``: the hybrid or MLA stack, or
    ``stack_apply`` with the block kind bound."""
    if kind == "hybrid":
        return tfm.hybrid_apply
    if kind == "mla":
        return tfm.mla_stack_apply
    return functools.partial(tfm.stack_apply, kind=kind)


_STACKS = ("blocks", "encoder")     # gathered a layer at a time


def forward(params, cfg, batch, *, mode: str = "prefill", remat: bool = False,
            use_kernels: bool = False, shard=None, fsdp=None) -> ModelOutputs:
    """``remat`` (train) recomputes each layer's activations in the backward
    pass.  Under an active mesh the rank runs its block (module docstring),
    which goes down to every layer: a prefill's batch rows, in decode
    ``shard``, the decode cache's block (:func:`cache_shard`, required on a
    mesh), in train ``shard``, the rank's block of the global batch, whose
    rows ``batch`` holds (required on a mesh), with ``fsdp`` the params'
    FSDP dims when they are FSDP-cut."""
    kind = _kind(cfg)
    _mla_one_device(cfg)
    mesh = sharding.active_mesh()
    if mode == "train":
        on_mesh = {}
        if mesh is not None:
            if shard is None:
                raise ValueError("train on a mesh takes shard=, the rank's "
                                 "block of the global batch "
                                 "(sharding.rank_shard), and its rows")
            on_mesh = {"shard": shard}
            if fsdp is not None:
                params = dict(params, **{
                    k: sharding.gather_fsdp(v, fsdp[k], mesh)
                    for k, v in params.items() if k not in _STACKS})
        x, positions, loss_mask = _embed_inputs(params, cfg, batch, shard)
        stack_fsdp = {} if fsdp is None else {"fsdp": fsdp["blocks"]}
        enc = {}
        if kind == "decoder_x":
            enc_out, enc_pos = _encode(
                params, cfg, batch, "train", remat, shard,
                None if fsdp is None else fsdp["encoder"])
            enc = {"enc_out": enc_out, "enc_positions": enc_pos}
        x, _, aux = _stack(kind)(params["blocks"], x, cfg, mode="train",
                                 positions=positions, remat=remat,
                                 use_kernels=use_kernels, **enc, **on_mesh,
                                 **stack_fsdp)
        logits, vocab = _train_logits(params, cfg, x, shard)
        return ModelOutputs(logits=logits, aux_loss=aux, loss_mask=loss_mask,
                            vocab=vocab)
    on_mesh = {}          # {"shard": this rank's block} on a mesh
    if mode == "prefill":
        if mesh is not None:      # this rank's batch rows
            shard = sharding.rank_shard(mesh, batch["tokens"].shape[0])
            rows = slice(shard.b0, shard.b0 + shard.B_loc)
            batch = dict(batch, **{k: batch[k][rows] for k in
                                   ("tokens", "frontend") if k in batch})
            on_mesh["shard"] = shard
        x, positions, _ = _embed_inputs(params, cfg, batch,
                                        on_mesh.get("shard"))
        enc = {}
        if kind == "decoder_x":
            enc_out, enc_pos = _encode(params, cfg, batch,
                                       use_kernels=use_kernels, **on_mesh)
            enc = {"enc_out": enc_out, "enc_positions": enc_pos}
        prefix = batch.get("prefix")
        if prefix is not None:
            if kind != "dense":
                raise ValueError("prefix resume only supports dense stacks, "
                                 f"not {kind!r}")
            q_rows = prefix["self"]["k"].shape[2]
            x, caches, aux = tfm.stack_apply(
                params["blocks"], x[:, q_rows:], cfg, kind=kind, mode="resume",
                positions=positions[q_rows:], caches=prefix,
                use_kernels=use_kernels, **on_mesh)
        else:
            x, caches, aux = _stack(kind)(params["blocks"], x, cfg,
                                          mode="prefill", positions=positions,
                                          use_kernels=use_kernels, **enc,
                                          **on_mesh)
        # only the last position's logits are needed
        return ModelOutputs(logits=_logits(params, cfg, x[:, -1:],
                                           on_mesh.get("shard")),
                            aux_loss=aux, cache=caches)

    if mode != "decode":
        raise NotImplementedError(f"forward mode {mode!r} is not ported yet")
    token, cache, idx = batch["token"], batch["cache"], batch["cache_index"]
    if mesh is not None:          # this rank's batch rows and cache block
        if shard is None or shard.B != token.shape[0]:
            raise ValueError("decode on a mesh takes shard=, the decode "
                             "cache's block (model.cache_shard) for a batch "
                             f"of {token.shape[0]}")
        rows = slice(shard.b0, shard.b0 + shard.B_loc)
        token = token[rows]
        if torch.is_tensor(idx) and idx.dim():
            idx = idx[rows]
        on_mesh["shard"] = shard
    x = _embed(params, cfg, token, on_mesh.get("shard"))
    if torch.is_tensor(idx) and idx.dim():   # per-slot cache indices [B]
        positions = idx.to(torch.int32)[:, None]
    else:
        positions = torch.as_tensor(idx, dtype=torch.int32,
                                    device=token.device).reshape(1)
    x, caches, aux = _stack(kind)(params["blocks"], x, cfg, mode="decode",
                                  positions=positions, caches=cache,
                                  cache_index=idx, use_kernels=use_kernels,
                                  **on_mesh)
    return ModelOutputs(logits=_logits(params, cfg, x, on_mesh.get("shard")),
                        aux_loss=aux, cache=caches)


def cross_entropy(logits, labels, mask=None, *, vocab=None):
    """Mean next-token NLL in f32: logsumexp over the vocab minus the gold
    logit (picked with a gather where JAX contracts a one-hot; adding zeros
    is exact, so the two agree).  ``mask`` (broadcast to the NLL's shape)
    averages over the positions it keeps.  ``vocab`` (a
    ``layers.VocabBlock``): ``logits`` are this rank's block of the
    vocabulary (``forward(mode="train")`` on a mesh), reduced over "model"
    without a whole-vocabulary tensor: the blocks' logsumexps
    (:class:`_BlockTerms`) gathered as [m, ..] and merged by a logsumexp
    (``gather_partial``: each rank's gradient is its slice), the gold
    logit from the rank whose block holds the label, summed
    (``reduce_partial``: the gradient passes through)."""
    if vocab is not None:
        mesh, start, size = vocab
        lse, gold = _BlockTerms.apply(logits, labels, start, size)
        blocks = coll.gather_partial(lse, mesh, ("model",))    # [m, ..]
        nll = torch.logsumexp(blocks, dim=0) \
            - coll.reduce_partial(gold, mesh, ("model",))
    else:
        lf = logits.float()
        gold = lf.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
        nll = torch.logsumexp(lf, dim=-1) - gold
    if mask is not None:
        m = torch.broadcast_to(mask, nll.shape).float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


class _BlockTerms(torch.autograd.Function):
    """(lse, gold) [..] of a block of logits [.., n] holding vocabulary
    columns [start, start + n) of ``size``: the block's own logsumexp in
    f32 (the columns past ``size`` left out) and the label's logit where the
    block holds it (0 elsewhere).  The backward rebuilds the softmax from
    the saved block in one f32 buffer, where autograd through ``logsumexp``
    would keep an f32 copy of the block and make three more."""

    @staticmethod
    def forward(ctx, logits, labels, start: int, size: int):
        n = logits.shape[-1]
        lf = logits.float()
        pad = None
        if start + n > size:
            pad = torch.arange(n, device=logits.device) >= size - start
            lf = lf.masked_fill(pad, torch.finfo(torch.float32).min)
        lse = torch.logsumexp(lf, dim=-1)
        rel = labels.long() - start
        mine = (rel >= 0) & (rel < n)
        idx = rel.clamp(0, n - 1).unsqueeze(-1)
        gold = torch.where(mine, lf.gather(-1, idx).squeeze(-1), 0.0)
        ctx.save_for_backward(logits, lse, idx, mine)
        ctx.pad = pad
        return lse, gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        logits, lse, idx, mine = ctx.saved_tensors
        p = logits.to(torch.float32, copy=True)
        if ctx.pad is not None:
            p.masked_fill_(ctx.pad, -math.inf)
        p.sub_(lse.unsqueeze(-1)).exp_().mul_(g_lse.unsqueeze(-1))
        p.scatter_add_(-1, idx, (g_gold * mine).unsqueeze(-1))
        return p.to(logits.dtype), None, None, None


# ---------------------------------------------------------------------------
def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Parameter count from the config alone (the JAX package's formula);
    ``active_only`` counts the routed experts a token uses."""
    if is_mla(cfg):
        return _count_mla(cfg, active_only)
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    attn_p = d * h * dh * 2 + d * hkv * dh * 2 if h else 0

    def mlp_p(width):
        return (3 if cfg.mlp_type == "swiglu" else 2) * d * width

    di, n = cfg.d_inner, cfg.ssm_state
    mamba_p = 0
    if cfg.ssm_state:
        mamba_p = d * 2 * di + cfg.ssm_conv * di + di + di * d + di
        if cfg.mamba_version == 1:
            r = cfg.ssm_dt_rank
            mamba_p += di * (r + 2 * n) + r * di + di + di * n
        else:
            hs = di // cfg.ssm_head_dim
            mamba_p += di * 2 * n + di * hs + 3 * hs

    if cfg.family == "ssm":
        total = cfg.num_layers * mamba_p
    elif cfg.family == "hybrid":
        total = cfg.num_layers * mamba_p + (attn_p + mlp_p(f))  # shared once
    elif cfg.num_experts:
        e_frac = (cfg.experts_per_token / cfg.num_experts) if active_only else 1.0
        expert = 3 * d * f * cfg.num_experts * e_frac
        shared = mlp_p(f * cfg.num_shared_experts) if cfg.num_shared_experts else 0
        total = cfg.num_layers * (attn_p + d * cfg.num_experts + expert + shared)
    else:
        total = cfg.num_layers * (attn_p + mlp_p(f))
        if cfg.encoder_layers:
            total += cfg.num_layers * attn_p
            total += cfg.encoder_layers * (attn_p + mlp_p(f))
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.frontend:
        total += (cfg.frontend_dim or d) * d
    return int(total)


def _count_mla(cfg, active_only: bool) -> int:
    """An ``MLAConfig``'s parameters, as ``init_params`` lays them out."""
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dr, dv = cfg.qk_rope_head_dim, cfg.v_head_dim
    attn = (d * h * cfg.qk_head_dim + d * (r + dr) + r
            + r * h * (cfg.qk_nope_head_dim + dv) + h * dv * d)
    norms = 2 * d
    experts = cfg.experts_per_token if active_only else cfg.num_experts
    moe = (d * cfg.num_experts + cfg.num_experts              # router, bias
           + 3 * d * cfg.d_ff * (experts + cfg.num_shared_experts))
    k = cfg.first_k_dense
    total = (k * (attn + norms + 3 * d * cfg.dense_d_ff)
             + (cfg.num_layers - k) * (attn + norms + moe))
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d
    return int(total)
