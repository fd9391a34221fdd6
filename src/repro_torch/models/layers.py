"""Shared neural layers: norms, MLP, RoPE, embeddings.

Plain functions on tensors; params are dicts in the JAX package's keys and
layout, so the L-stacked trees of both packages compare like with like.
On a mesh whose "model" axis cuts a vocab table, ``vocab_embed`` and
``vocab_logits`` run this rank's part of it, on its vocab rows
(``launch.mesh.TABLE_CUTS`` "vocab") or, where the axis does not divide
the vocabulary, on its D columns ("d"), and are differentiable.  On rows:
the embedding's sum passes the gradient through
(``collectives.reduce_partial``), the logits' input sums its gradient over
"model" (``enter_partial``) and the gathered logits hand each rank its
slice of theirs (``gather_partial``).  On D: the embedding's columns are
gathered (``gather_partial``), the logits are a partial sum over the
rank's D columns of the input (``enter_partial``, then
``reduce_partial``).  ``gather_cols`` joins any rank's columns.

Training keeps the logits vocab-parallel: ``vocab_block_logits`` gives
this rank its block of ⌈V/m⌉ vocabulary columns and no rank builds a
[.., V] tensor (``models.model.cross_entropy`` reduces the blocks).  On
rows the block is ``x @ table.T`` of the rank's rows; on D the table's
rows of the block are gathered with every D column (one gather of the
table, ``gather_to_partial``: each rank's gradient sums over "model"
before it takes its columns).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def normal_stack(gen: torch.Generator, shape, scale: float, dtype,
                 device) -> torch.Tensor:
    """N(0, scale**2) draws of ``shape`` in ``dtype``, made one slice of the
    leading (layer) axis at a time into a preallocated tensor, so the f32
    transient is one layer's and not the whole stack's (moonshot's
    [48,64,2048,1408] expert stacks would need 35 GB each in f32).  On the
    meta device, which holds no values, the empty tensor itself."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen, device=device) * scale
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_init(cfg, d: int, device) -> dict:
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "nonparametric":
        return {}
    raise ValueError(cfg.norm_type)


def norm_apply(params, x: torch.Tensor, cfg, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32 (with the f32 ``scale``) and cast back to x's dtype."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"]
    else:  # layernorm / nonparametric
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm_type == "layernorm":
            y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """SwiGLU, or a plain 2-matrix MLP: squared ReLU (nemotron) or gelu
    (``jax.nn.gelu``'s default tanh approximation)."""
    if cfg.mlp_type == "swiglu":
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        return (F.silu(g) * u) @ params["w_down"]
    if cfg.mlp_type == "squared_relu":
        return torch.square(F.relu(x @ params["w_up"])) @ params["w_down"]
    if cfg.mlp_type == "gelu":
        return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]
    raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half, not interleaved)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: [..., S] int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # [dh/2]
    ang = positions[..., None].float() * freqs              # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed_apply(params, x: torch.Tensor, *, tied_table=None) -> torch.Tensor:
    table = tied_table if tied_table is not None else params["table"]
    return x @ table.T


def gather_cols(part: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's columns [.., n] gathered along the last dim over
    "model" (rank i's are [i n, (i + 1) n)): one all_reduce of a
    zero-filled buffer; each rank's gradient is its columns'."""
    blocks = coll.gather_partial(part, mesh, ("model",))   # [m, ..., n]
    return torch.movedim(blocks, 0, -2).flatten(-2)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, mesh, *,
                cut: str = "vocab") -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's part of a table cut
    over "model".  ``cut`` "vocab": rank i holds rows [i V_loc, (i + 1)
    V_loc): a masked lookup, then one all_reduce (each row comes from
    exactly one rank, the rest add zeros, so the result is exact).  "d": it
    holds every row's D columns [i D_loc, (i + 1) D_loc): a lookup, then
    the columns gathered (:func:`gather_cols`, exact too)."""
    if cut == "d":
        return gather_cols(table[tokens], mesh)
    V_loc = table.shape[0]
    rel = tokens - mesh.axis_index("model") * V_loc
    mine = (rel >= 0) & (rel < V_loc)
    x = table[rel.clamp(0, V_loc - 1)] * mine[..., None].to(table.dtype)
    return coll.reduce_partial(x, mesh, ("model",))


class VocabBlock(NamedTuple):
    """Where a rank's block of vocab-parallel logits lies: columns
    [start, start + n) of a vocabulary of ``size`` over the "model" axis
    of ``mesh`` (n, the block's last dim, is ⌈size/m⌉ on every rank: the
    last block's columns past ``size`` are padding and hold no token)."""
    mesh: Any
    start: int
    size: int


def vocab_block_logits(x: torch.Tensor, table: torch.Tensor, mesh, *,
                       cut: str = "vocab"):
    """(logits [.., ⌈V/m⌉], its :class:`VocabBlock`): ``x @ table.T`` on
    this rank's block of the vocabulary from its part of a table cut over
    "model".  ``cut`` "vocab": the rank's own rows.  "d": the table's rows
    of the block, every D column, from one gather of the table (the last
    block padded with zero columns when m does not divide V).  ``x``'s
    gradient is summed over "model"."""
    x = coll.enter_partial(x, mesh, ("model",))
    mi = mesh.axis_index("model")
    if cut != "d":
        V_loc = table.shape[0]
        return x @ table.T, VocabBlock(mesh, mi * V_loc,
                                       V_loc * mesh.shape["model"])
    V = table.shape[0]
    n = -(-V // mesh.shape["model"])
    start = mi * n
    rows = max(min(n, V - start), 0)
    blocks = coll.gather_to_partial(table, mesh, ("model",))  # [m, V, D/m]
    w = torch.movedim(blocks.narrow(1, min(start, V), rows), 0, -2).flatten(-2)
    logits = x @ w.T
    if rows < n:
        logits = F.pad(logits, (0, n - rows))
    return logits, VocabBlock(mesh, start, V)


def vocab_logits(x: torch.Tensor, table: torch.Tensor, mesh, *,
                 cut: str = "vocab") -> torch.Tensor:
    """``x @ table.T`` over the whole vocabulary from this rank's part of
    a table cut over "model".  ``cut`` "vocab": each rank's [.., V_loc]
    block gathered (one all_reduce of a zero-filled buffer) into [.., V].
    "d": ``x``'s D columns of this rank against the table's, a partial
    [.., V] summed in one all_reduce."""
    x = coll.enter_partial(x, mesh, ("model",))
    if cut == "d":
        D_loc = table.shape[1]
        part = x.narrow(-1, mesh.axis_index("model") * D_loc, D_loc) @ table.T
        return coll.reduce_partial(part, mesh, ("model",))
    return gather_cols(x @ table.T, mesh)
