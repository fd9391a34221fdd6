"""GQA self- and cross-attention with a KV cache (bf16/f32 or int8).

Prefill ("full" mode, self- and cross-attention) goes, with kernels on,
through the hand-written CUDA ``prefill_attention`` kernel wherever it
takes the tensors (bf16 on the card, a head width it holds, no gradient
wanted: ``kernels/prefill_attention.py:refusal``); everything else -- the
CPU, f32, training's forward, the meta device's dry run -- takes
:func:`chunked_attention`, the chunked online-softmax formulation of the
JAX package (plain tensor code, the same masks and padding sentinels),
which is also the kernel's plain version.  Decode is one
query token against the cache: with kernels on it goes through the
hand-written CUDA ``decode_attention`` kernel, else through its plain
version.  That holds for every cache kind: the self cache, the audio
decoder's cross cache over the encoder's rows, and the int8 cache, whose
rows are dequantized to f32 and attended with an f32 query.  A prefill can
resume from cached post-RoPE prefix K/V.

Multi-head latent attention (:func:`mla_apply`, an ``MLAConfig``'s layers)
caches one row a token, the RMS-normed latent and the rope'd key part
shared by the heads.  Its prefill expands the latent into per-head keys
and values and attends as above (the kernel's qk 192 / v 128 instance);
its decode absorbs the key expansion into the query and attends the
latent rows themselves through the ``mla_decode_attention`` kernel (or
its plain version), then expands the latent output through the value
half.  It runs on one device: no mesh, prefix resume or int8 cache.

Both decode call sites, :func:`decode_attend` in :func:`attn_apply` (self
and cross decode; :func:`decode_attend_int8` over an int8 cache) and
:func:`mla_decode_attend` in :func:`mla_apply`, go through
:func:`decode_break`: it calls the module's function by name, or, while
``serving/decode_graph.py`` records or captures a decode step on this
thread, hands the call to that recorder, which ends one CUDA graph there
and begins the next.

On a mesh (``shard``, a :class:`~repro_torch.models.sharding.RankShard`)
the projections are cut over "model" as ``launch.mesh.param_spec`` places
them (``shard.cuts(cfg).attn``, one of ``launch.mesh.ATTN_CUTS``):

* "heads" (the axis divides the kv heads): each rank attends its query
  and kv heads; the partial output projections meet in one all_reduce.
* "q" (it divides the query heads only): ``wk``/``wv`` hold D rows, so k
  and v are partial sums over the rank's D columns of the input, summed in
  one all_reduce; a prefill attends the rank's query heads over the kv
  heads they map to (a rank's heads may span two), a decode gathers the
  query heads over "model" (in the same all_reduce as k and v), attends
  them all over the rank's cache rows, and keeps its own; the output
  projection is partial, as with "heads".
* "d" (it divides neither): q, k and v are partial sums over D rows, summed
  in one all_reduce; the attention runs whole on every rank (on its cache
  rows in decode) and ``wo``'s D columns give the rank's columns of the
  output, gathered along D.

Self- and cross-attention alike.  In training the split's inputs (the
normed ``x``, cross-attention's ``kv_x`` and the q/k-norm scales,
replicated values entering rank-partial work) pass
``collectives.enter_partial``, a partial projection that feeds the
attention passes ``reduce_to_partial`` (its gradient is partial too and is
summed), the output projection ``reduce_partial`` and the D gather
``gather_partial``, so autograd sums every gradient over "model" once.  A
sequence-sharded cache (the layout ``seq_shard_layout`` gives) is written
only by the rank that owns the row, with no collective
(``cache_update``), and decode runs the kernel on each rank's own rows
with ``lse``; the partial outputs merge across the sequence axes by their
log-sum-exps (``merge_shards``).
"""
from __future__ import annotations

import math
import threading

import torch

from repro_torch import tracing
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import costs, ops
from repro_torch.kernels import prefill_attention as prefill_kernel
from repro_torch.models.layers import (apply_rope, gather_cols, norm_apply,
                                       normal_stack)


def attn_init(gen: torch.Generator, cfg, dtype, device, n_layers: int, *,
              cross: bool = False) -> dict:
    """L-stacked attention weights at the JAX package's init scales; a
    cross-attention block has no q/k norm."""
    d, h, hkv, dh, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, n_layers)

    def normal(shape, scale):
        return normal_stack(gen, shape, scale, dtype, device)

    s = 1.0 / math.sqrt(d)
    p = {"wq": normal((L, d, h, dh), s),
         "wk": normal((L, d, hkv, dh), s),
         "wv": normal((L, d, hkv, dh), s),
         "wo": normal((L, h, dh, d), 1.0 / math.sqrt(h * dh))}
    if cfg.qk_norm and not cross:
        p["q_norm"] = {"scale": torch.ones((L, dh), device=device)}
        p["k_norm"] = {"scale": torch.ones((L, dh), device=device)}
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


class _RMS:  # rmsnorm over head_dim (qk-norm)
    norm_type = "rmsnorm"


def _qkv(params, x, kv_x, cfg, q_positions, kv_positions, *, rope: bool,
         cut=None, mesh=None):
    """q, k and v of ``x`` (queries) and ``kv_x`` (keys and values) under
    ``cut`` (the module docstring's cases; None or "heads": the rank's own
    heads, no collective)."""
    if cut == "q":
        q = _proj(x, params["wq"])
        k, v = _sum_partial([_proj(_d_cols(kv_x, params["wk"], mesh), params[w])
                             for w in ("wk", "wv")], mesh)
    elif cut == "d":
        q, k, v = _sum_partial(
            [_proj(_d_cols(x, params["wq"], mesh), params["wq"])]
            + [_proj(_d_cols(kv_x, params["wk"], mesh), params[w])
               for w in ("wk", "wv")], mesh)
    else:
        q = _proj(x, params["wq"])
        k = _proj(kv_x, params["wk"])
        v = _proj(kv_x, params["wv"])
    if "q_norm" in params:
        q = norm_apply(params["q_norm"], q, _RMS)
        k = norm_apply(params["k_norm"], k, _RMS)
    if rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _d_cols(x, w, mesh):
    """This rank's D columns of ``x`` [.., D]: the rows of a projection
    ``w`` [D_loc, ..] cut on D (rank i holds [i D_loc, (i + 1) D_loc))."""
    D_loc = w.shape[0]
    return x.narrow(-1, mesh.axis_index("model") * D_loc, D_loc)


def _sum_partial(parts, mesh):
    """The sums over "model" of rank-partial projections, in one
    all_reduce; they feed the attention, which in training hands back a
    partial gradient (``reduce_to_partial``)."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    flat = coll.reduce_to_partial(flat, mesh, ("model",))
    return [t.view(p.shape)
            for t, p in zip(flat.split([p.numel() for p in parts]), parts)]


def _rank_heads(cfg, mesh):
    """(h0, H_loc): this rank's query heads under the "q" cut."""
    H_loc = cfg.num_heads // mesh.shape["model"]
    return mesh.axis_index("model") * H_loc, H_loc


def _kv_for_heads(t, cfg, h0, H_loc):
    """The kv head each query head [h0, h0 + H_loc) reads, one per query
    head: t [B,S,Hkv,dh] -> [B,S,H_loc,dh] (the rank's heads may span two
    kv heads)."""
    g = cfg.num_heads // cfg.num_kv_heads
    idx = torch.arange(h0, h0 + H_loc, device=t.device) // g
    return t.index_select(2, idx)


def _decode_qkv_q(params, x, cfg, positions, mesh):
    """A "q" cut's decode projections: this rank's query heads (normed and
    RoPE'd) gathered over "model" in the one all_reduce that sums k's and
    v's partial projections.  Returns q [B,1,H,dh], k and v [B,1,Hkv,dh]."""
    q = _proj(x, params["wq"])
    if "q_norm" in params:
        q = norm_apply(params["q_norm"], q, _RMS)
    q = apply_rope(q, positions, cfg.rope_theta)
    slots = torch.zeros((mesh.shape["model"], *q.shape), dtype=q.dtype,
                        device=q.device)
    slots[mesh.axis_index("model")] = q
    x_r = _d_cols(x, params["wk"], mesh)
    qs, k, v = _sum_partial([slots, _proj(x_r, params["wk"]),
                             _proj(x_r, params["wv"])], mesh)
    if "k_norm" in params:
        k = norm_apply(params["k_norm"], k, _RMS)
    k = apply_rope(k, positions, cfg.rope_theta)
    return torch.movedim(qs, 0, 2).flatten(2, 3), k, v


def _all_heads(q, mesh):
    """Every rank's query heads [B,1,H_loc,dh] gathered along the head dim
    over "model": [B,1,H,dh]."""
    blocks = coll.gather_partial(q.contiguous(), mesh, ("model",))
    return torch.movedim(blocks, 0, 2).flatten(2, 3)


# ---------------------------------------------------------------------------
def _query_chunk(qc, qpos, k, v, kv_positions, once: bool, kv_chunk: int,
                 causal: bool, window: int):
    """One query chunk's online softmax over every key chunk: qc [B,Cq,H,dh]
    f32 at ``qpos`` [Cq] -> [B,Cq,H,dv] f32 (dv: v's width).  ``once``: two
    key chunks run and count for all (``costs.trips``)."""
    B, Cq, H, dh = qc.shape
    nk = k.shape[1] // kv_chunk
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((B, H, Cq), -math.inf, device=qc.device)
    l = torch.zeros((B, H, Cq), device=qc.device)
    acc = torch.zeros((B, H, Cq, v.shape[-1]), device=qc.device)
    for ki in costs.trips(nk, once):
        sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
        kc, vc, kpos = k[:, sl].float(), v[:, sl].float(), kv_positions[sl]
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
        mask = kpos[None, :] < 2**30                          # padding keys
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window:
            mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]              # [B,H,Cq,dh]
    return out.permute(0, 2, 1, 3)


def chunked_attention(q, k, v, *, causal: bool, window: int,
                      q_positions, kv_positions,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Online-softmax attention.

    q: [B,Sq,H,dh]; k: [B,Sk,Hkv,dh]; v: [B,Sk,Hkv,dv] (dv = dh but for
    MLA's prefill); scale 1/sqrt(dh); positions give global indices used
    for the causal / sliding-window mask (padded queries carry -1, padded
    keys 2**30).  Returns [B,Sq,H,dv] in v's dtype.

    Every (query chunk, key chunk) pair has the same shapes, so on the meta
    device with no gradient recorded (the dry run's prefill) two chunks of
    each run and count for all (``kernels/costs.py:trips``).
    """
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    pq = (-Sq) % q_chunk
    pk = (-Sk) % kv_chunk
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        q_positions = torch.nn.functional.pad(q_positions, (0, pq), value=-1)
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pk),
                                               value=2**30)
    nq, nk = q.shape[1] // q_chunk, k.shape[1] // kv_chunk
    once = costs.once(q, k, v)
    outs = [t.permute(0, 2, 1, 3) for t in costs.stand_ins(
        nq - costs.ran(nq, once), (B, H, q_chunk, v.shape[-1]), torch.float32,
        q.device)]
    for qi in costs.trips(nq, once):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        outs.append(_query_chunk(q[:, rows].float(), q_positions[rows], k, v,
                                 kv_positions, once, kv_chunk, causal,
                                 window))
    return torch.cat(outs, dim=1)[:, :Sq].to(v.dtype)


# ---------------------------------------------------------------------------
def cache_update(cache: torch.Tensor, new: torch.Tensor, index,
                 shard=None) -> torch.Tensor:
    """Write one token's K or V into ``cache`` [B,S,Hkv,dh] at ``index``
    (sequence axis 1), IN PLACE -- the JAX engine donates the cache, so the
    port updates the buffer it was given and returns it.

    ``index`` is a scalar (every row at one position) or a per-slot [B]
    tensor.  Like ``dynamic_update_slice`` an out-of-range index is clamped
    into [0, S-1].  On a sequence-sharded cache (``shard.seq``) ``cache``
    holds this rank's rows [s0, s0 + S_loc) and ``index`` counts global
    positions: the rank writes the rows that land on it and leaves the
    rest, moving no collective bytes."""
    B, S = cache.shape[:2]
    index = torch.as_tensor(index, device=cache.device)
    new = new.to(cache.dtype)
    if shard is not None and shard.seq is not None:
        local = index - shard.s0
        mine = (local >= 0) & (local < S)
        local = local.clamp(0, S - 1).long()
        rows = torch.arange(B, device=cache.device)
        if not index.dim():
            local, mine = local.expand(B), mine.expand(B)
        cur = cache[rows, local]
        cache[rows, local] = torch.where(mine[:, None, None], new[:, 0], cur)
        return cache
    if index.dim():
        rows = torch.arange(B, device=cache.device)
        cache[rows, index.clamp(0, S - 1).long()] = new[:, 0]
    else:
        cache.index_copy_(1, index.clamp(0, S - 1).long().reshape(1), new)
    return cache


def merge_shards(out: torch.Tensor, lse: torch.Tensor, mesh,
                 axes) -> torch.Tensor:
    """Merge the sequence shards' partial decode outputs: ``o = sum_r
    exp(lse_r - lse) o_r`` with ``lse = log sum_r exp(lse_r)``, over the
    ranks along ``axes``.  out: [B,1,H,dh]; lse: [B,H] f32 (-inf for a
    shard with no row in the window).  A row no shard attends gives 0 (the
    kernel's contract).  Two all_reduces: the max of the lse, then the
    weighted outputs with their weights in one buffer."""
    top = coll.all_reduce(lse.clone(), mesh, axes, op="max")
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.where(torch.isfinite(lse), torch.exp(lse - top),
                    torch.zeros_like(lse))                        # [B,H]
    packed = torch.cat([out[:, 0].float() * w[..., None], w[..., None]], -1)
    coll.all_reduce(packed, mesh, axes)                           # [B,H,dh+1]
    merged = packed[..., :-1] / torch.clamp(packed[..., -1:], min=1e-20)
    return merged[:, None].to(out.dtype)


def decode_attend(q, k_cache, v_cache, cache_len, *, window: int,
                  use_kernels: bool, shard=None) -> torch.Tensor:
    """``ops.decode_attention`` over the cache this rank holds.  On a
    sequence-sharded cache the global lengths and window become this
    shard's rows: ``len - s0`` clamped into [0, S_loc], and the window's
    first row as the kernel's per-slot ``start``; the shards' results
    merge by :func:`merge_shards`."""
    if shard is None or shard.seq is None:
        return ops.decode_attention(q, k_cache, v_cache, cache_len,
                                    window=window, use_kernels=use_kernels)
    B, S_loc = k_cache.shape[:2]
    cl = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
    cl = cl.reshape(-1).expand(B)
    local_len = (cl - shard.s0).clamp(0, S_loc)
    start = (cl - window - shard.s0).clamp(0, S_loc) if window else None
    out, lse = ops.decode_attention(q, k_cache, v_cache, local_len,
                                    start=start, lse=True,
                                    use_kernels=use_kernels)
    return merge_shards(out, lse, shard.mesh, shard.seq.s_axes)


def decode_attend_int8(q, k8, k_scale, v8, v_scale, cache_len, *,
                       window: int, use_kernels: bool, shard=None):
    """:func:`decode_attend` in f32 over an int8 cache (values [...,Hkv,dh]
    int8 and their f32 scales [...,Hkv,1]), dequantized here: a decode
    graph's break keeps the int8 leaves, and the f32 copies live only for
    the call."""
    return decode_attend(q.float(), k8.float() * k_scale,
                         v8.float() * v_scale, cache_len, window=window,
                         use_kernels=use_kernels, shard=shard)


# the decode-step recorder on this thread (``serving/decode_graph.py``);
# None while no decode step is recorded or captured
_breaks = threading.local()


def decode_break(name: str, *args, **kw):
    """``<name>(*args, **kw)``, a decode-attention function of this module
    looked up at the call (so a wrapper put in its place sees the call), or,
    while a recorder is set on this thread, ``recorder(name, args, kw)``."""
    rec = getattr(_breaks, "recorder", None)
    if rec is None:
        return globals()[name](*args, **kw)
    return rec(name, args, kw)


def quantize_kv(t: torch.Tensor):
    """Absmax int8 per (batch, position, head): t [..., Hkv, dh] -> (int8
    values, f32 scale [..., Hkv, 1]).  Rounds half to even, as JAX does."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(tf / scale), -127, 127)
    return q.to(torch.int8), scale


def attn_apply(params, x, cfg, *, positions, mode: str, causal: bool = True,
               cache=None, cache_index=None, use_kernels: bool = False,
               kv_x=None, kv_positions=None, cross: bool = False,
               prefix_kv=None, shard=None):
    """mode "full":   self-attention over x (prefill); returns (out, (k, v)).
                   ``prefix_kv=(k_pre, v_pre)`` resumes a prefill from
                   cached post-RoPE K/V of positions [0, q): x holds only
                   the tail rows (``positions`` are their global indices),
                   the queries attend over prefix + tail keys, and the
                   returned k/v are the full-length concatenation, laid out
                   like a cold prefill's.
    mode "decode": x is [B,1,D]; cache = {"k","v"} [B,S,Hkv,dh], updated in
                   place at ``cache_index`` (scalar or [B]); returns
                   (out, cache).  An int8 cache also holds f32 ``k_scale``
                   / ``v_scale`` [B,S,Hkv,1]: the new row is quantized into
                   it and the whole cache dequantized to f32 for the
                   attention.
    Cross-attention: in mode "full" ``kv_x`` [B,F,D] (at ``kv_positions``)
    gives the keys and values, without RoPE, causal mask or window; in mode
    "decode" (``cross=True``) the query attends over the cache's F rows,
    which the decode never writes.  ``shard``: this rank's block on a mesh
    (see the module docstring); a cross cache holds the rank's batch rows
    and kv heads ("heads"; every kv head otherwise) of all F rows, never a
    sequence shard."""
    cross = cross or kv_x is not None
    cut = shard.cuts(cfg).attn if shard is not None else None
    mesh = shard.mesh if cut is not None else None
    if cut is not None:
        x = coll.enter_partial(x, mesh, ("model",))
        if kv_x is not None:
            kv_x = coll.enter_partial(kv_x, mesh, ("model",))
        params = dict(params, **{
            k: {"scale": coll.enter_partial(params[k]["scale"], mesh,
                                            ("model",))}
            for k in ("q_norm", "k_norm") if k in params})

    def project(out):
        y = _out_proj(out.to(x.dtype), params["wo"])
        if cut == "d":            # this rank's D columns, gathered along D
            return gather_cols(y, mesh)
        return coll.reduce_partial(y, mesh, ("model",)) if cut else y

    def attend(name, q, *caches, window, seq_shard):
        """Decode over a cache through ``name`` (``decode_attend`` or
        ``decode_attend_int8``); under "q" ``q`` holds every query head and
        the rank keeps its own."""
        out = decode_break(name, q, *caches, window=window,
                           use_kernels=use_kernels, shard=seq_shard)
        return out.narrow(2, *_rank_heads(cfg, mesh)) if cut == "q" else out

    def full(q, k, v, **kw):
        if cut == "q":
            h0, H_loc = _rank_heads(cfg, mesh)
            k, v = (_kv_for_heads(t, cfg, h0, H_loc) for t in (k, v))
        with tracing.span("attention.full"):
            if use_kernels and prefill_kernel.refusal(q, k, v) is None:
                return ops.prefill_attention(q, k, v, **kw)
            return chunked_attention(q, k, v, **kw)

    if mode == "full":
        if cross:
            q, k, v = _qkv(params, x, kv_x, cfg, positions, kv_positions,
                           rope=False, cut=cut, mesh=mesh)
            out = full(q, k, v, causal=False, window=0, q_positions=positions,
                       kv_positions=kv_positions)
            return project(out), (k, v)
        q, k, v = _qkv(params, x, x, cfg, positions, positions, rope=True,
                       cut=cut, mesh=mesh)
        kv_positions = positions
        if prefix_kv is not None:
            pk, pv = prefix_kv
            k = torch.cat([pk.to(k.dtype), k], dim=1)
            v = torch.cat([pv.to(v.dtype), v], dim=1)
            kv_positions = torch.arange(k.shape[1], device=k.device)
        out = full(q, k, v, causal=causal, window=cfg.sliding_window,
                   q_positions=positions, kv_positions=kv_positions)
        return project(out), (k, v)

    if mode != "decode":
        raise ValueError(f"unknown attention mode {mode!r}")
    if cross:
        if cut == "d":
            (q,) = _sum_partial([_proj(_d_cols(x, params["wq"], mesh),
                                       params["wq"])], mesh)
        else:
            q = _proj(x, params["wq"])
            if cut == "q":
                q = _all_heads(q, mesh)
        out = attend("decode_attend", q, cache["k"], cache["v"],
                     cache["k"].shape[1], window=0, seq_shard=None)
        return project(out), cache
    if cut == "q":
        q, k, v = _decode_qkv_q(params, x, cfg, positions, mesh)
    else:
        q, k, v = _qkv(params, x, x, cfg, positions, positions, rope=True,
                       cut=cut, mesh=mesh)
    if "k_scale" in cache:
        new_cache = {}
        for name, t in (("k", k), ("v", v)):
            qt, sc = quantize_kv(t)
            new_cache[name] = cache_update(cache[name], qt, cache_index, shard)
            new_cache[name + "_scale"] = cache_update(cache[name + "_scale"], sc,
                                                      cache_index, shard)
        out = attend("decode_attend_int8", q, new_cache["k"],
                     new_cache["k_scale"], new_cache["v"],
                     new_cache["v_scale"], cache_index + 1,
                     window=cfg.sliding_window, seq_shard=shard)
        return project(out), new_cache
    k_cache = cache_update(cache["k"], k, cache_index, shard)
    v_cache = cache_update(cache["v"], v, cache_index, shard)
    out = attend("decode_attend", q, k_cache, v_cache, cache_index + 1,
                 window=cfg.sliding_window, seq_shard=shard)
    return project(out), {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V3; configs.base.MLAConfig)
# ---------------------------------------------------------------------------
LATENT_NORM_EPS = 1e-6   # kv_a_layernorm's eps in the modeling code


def mla_init(gen: torch.Generator, cfg, dtype, device, n_layers: int) -> dict:
    """L-stacked MLA weights: ``wq`` [L,D,H,dn+dr] (each head's q without
    rope, then its rope part), ``wkv_a`` [L,D,r+dr] (the latent, then the
    rope key shared by the heads), the latent's RMSNorm ``kv_norm``,
    ``wkv_b`` [L,r,H,dn+dv] (each head's key without rope, then its value)
    and ``wo`` [L,H,dv,D]."""
    d, h, L = cfg.d_model, cfg.num_heads, n_layers
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)

    def normal(shape, scale):
        return normal_stack(gen, shape, scale, dtype, device)

    s = 1.0 / math.sqrt(d)
    return {"wq": normal((L, d, h, dn + dr), s),
            "wkv_a": normal((L, d, r + dr), s),
            "kv_norm": {"scale": torch.ones((L, r), device=device)},
            "wkv_b": normal((L, r, h, dn + dv), 1.0 / math.sqrt(r)),
            "wo": normal((L, h, dv, d), 1.0 / math.sqrt(h * dv))}


def _mla_rows(params, x, cfg, positions):
    """x [B,S,D] -> (q_nope [B,S,H,dn], q_pe [B,S,H,dr] rope'd, the latent
    cache rows [B,S,r+dr]: the RMS-normed latent, then the rope'd key
    part)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_pe = _proj(x, params["wq"]).split([dn, dr], dim=-1)
    c, k_pe = (x @ params["wkv_a"]).split([cfg.kv_lora_rank, dr], dim=-1)
    c = norm_apply(params["kv_norm"], c, _RMS, eps=LATENT_NORM_EPS)
    k_pe = apply_rope(k_pe.unsqueeze(-2), positions, cfg.rope_theta)
    return (q_nope, apply_rope(q_pe, positions, cfg.rope_theta),
            torch.cat([c, k_pe.squeeze(-2)], dim=-1))


def mla_prefill_attend(q, k, v, positions, *, use_kernels: bool):
    """Causal attention of a whole prompt with the latent expanded: q, k
    [B,S,H,dn+dr], v [B,S,H,dv] (contiguous) -> [B,S,H,dv]; the
    prefill_attention kernel where it takes the call, else
    :func:`chunked_attention`."""
    with tracing.span("attention.mla_prefill"):
        kw = dict(causal=True, window=0, q_positions=positions,
                  kv_positions=positions)
        if use_kernels and prefill_kernel.refusal(q, k, v) is None:
            return ops.prefill_attention(q, k, v, **kw)
        return chunked_attention(q, k, v, **kw)


def mla_decode_attend(q, latent, cache_len, *, scale: float, v_dim: int,
                      use_kernels: bool):
    """``ops.mla_decode_attention``: q [B,H,r+dr] (the absorbed query)
    over each slot's first ``cache_len`` latent rows [B,S,r+dr] ->
    [B,H,v_dim], V a row's first ``v_dim`` = r values."""
    with tracing.span("attention.mla_decode"):
        return ops.mla_decode_attention(q, latent, cache_len, scale=scale,
                                        v_dim=v_dim, use_kernels=use_kernels)


def mla_apply(params, x, cfg, *, positions, mode: str, cache=None,
              cache_index=None, use_kernels: bool = False):
    """mode "full":   causal self-attention over x [B,S,D] (prefill and
                   training); returns (out, {"latent": rows [B,S,r+dr]}).
    mode "decode": x is [B,1,D]; ``cache`` = {"latent": [B,S,r+dr]}, its
                   row at ``cache_index`` (scalar or [B]) written in place;
                   returns (out, cache).
    Scale 1/sqrt(dn + dr) in both."""
    H, dn, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q_nope, q_pe, rows = _mla_rows(params, x, cfg, positions)
    if mode == "full":
        B, S = x.shape[:2]
        c, k_pe = rows.split([r, cfg.qk_rope_head_dim], dim=-1)
        k_nope, v = (c @ params["wkv_b"].reshape(r, -1)).unflatten(
            -1, (H, -1)).split([dn, cfg.v_head_dim], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.unsqueeze(2).expand(B, S, H, -1)], dim=-1)
        out = mla_prefill_attend(q, k, v.contiguous(), positions,
                                 use_kernels=use_kernels)
        return _out_proj(out, params["wo"]), {"latent": rows}
    if mode != "decode":
        raise ValueError(f"unknown attention mode {mode!r}")
    latent = cache_update(cache["latent"].unsqueeze(2), rows.unsqueeze(2),
                          cache_index).squeeze(2)
    wk, wv = params["wkv_b"].split([dn, cfg.v_head_dim], dim=-1)
    # the key expansion absorbed into the query: q_nope . (c W_k) = (q_nope
    # W_k^T) . c, per head [B,dn] @ [dn,r]
    q_lat = torch.matmul(q_nope[:, 0].transpose(0, 1), wk.permute(1, 2, 0))
    q = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)
    o_lat = decode_break("mla_decode_attend", q, latent, cache_index + 1,
                         scale=1.0 / math.sqrt(cfg.qk_head_dim), v_dim=r,
                         use_kernels=use_kernels)
    # the value expansion after the attention: per head [B,r] @ [r,dv]
    out = torch.matmul(o_lat.transpose(0, 1), wv.permute(1, 0, 2))
    return _out_proj(out.transpose(0, 1).unsqueeze(1), params["wo"]), \
        {"latent": latent}
