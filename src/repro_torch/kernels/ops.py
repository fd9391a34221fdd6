"""Public kernel entry points, and the one place that picks kernel or plain.

A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor, or a call with ``use_kernels=False``, takes the plain PyTorch
version.  There is no fallback from the kernel to the plain version.
``grouped_ffn`` and ``ssm_scan`` are differentiable on every device
(``kernels/autograd.py``); ``ssm_scan``'s backward on the card is the
hand-written ``repro_ssm_scan_bwd``, counted as ``ssm_scan_bwd``.
``use_kernels`` is the port's counterpart of the JAX package's
``use_pallas``: ``"auto"`` means "the tensors are on CUDA" (or on the meta
device, which stands for the card).

On the meta device (the dry run, ``launch/dryrun.py``) each kernel entry
returns empty outputs of the kernel's shapes and dtypes and never runs the
plain version (the recurrence's loops over S in Python).  Every kernel
call, a launch on the card or its meta stand-in, is recorded with its
``kernels/costs.py`` cost in the active counters (``costs.counted``).

``admit_state`` / ``admit_slots`` and ``splice_blocks`` are the continuous
engine's admission ops.  In the JAX package they are XLA scatters, not
Pallas kernels; here they are plain in-place index writes on the tensors
the caller hands in (where JAX donates them).
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch import tracing
from repro_torch.kernels import costs, ref
from repro_torch.kernels.autograd import GroupedFFN, SSMScan
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.grouped_ffn import (check_counts, grouped_ffn_cuda,
                                             grouped_ffn_sorted_cuda)
from repro_torch.kernels.masked_compact import masked_compact_cuda
from repro_torch.kernels.mla_decode_attention import (
    mla_decode_attention_cuda, refusal as mla_refusal)
from repro_torch.kernels.prefill_attention import prefill_attention_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda, ssm_scan_cuda

_WRAPPERS = {"decode_attention": decode_attention_cuda,
             "masked_compact": masked_compact_cuda,
             "grouped_ffn": grouped_ffn_cuda,
             "grouped_ffn_sorted": grouped_ffn_sorted_cuda,
             "ssm_scan": ssm_scan_cuda,
             "ssm_scan_bwd": ssm_scan_bwd_cuda,
             "prefill_attention": prefill_attention_cuda,
             "mla_decode_attention": mla_decode_attention_cuda}


def resolve_use_kernels(use_kernels: Union[bool, str],
                        device: torch.device) -> bool:
    """``"auto"`` -> kernels exactly when ``device`` is a CUDA device or
    the meta device (which stands for the card)."""
    if use_kernels == "auto":
        return torch.device(device).type in ("cuda", "meta")
    return bool(use_kernels)


def attended_rows(cache_len, start, window: int, B: int, S: int,
                  device: torch.device) -> int:
    """The K/V rows a decode call attends, summed over its ``B`` slots:
    each slot's rows ``max(start, len - window, 0) <= pos < min(len, S)``.
    On the meta device the lengths hold no data: every row of each slot's
    window (of a Python-int length, its rows exactly).  On the card this
    reads the lengths back (a sync; only while a counter is active)."""
    if isinstance(cache_len, int) and (start is None or device.type == "meta"):
        hi = min(max(cache_len, 0), S)
        lo = max(cache_len - window, 0) if window else 0
        return B * max(hi - lo, 0)
    if device.type == "meta":
        return B * (min(S, window) if window else S)
    cl = torch.as_tensor(cache_len, device=device).to(torch.int64)
    cl = cl.reshape(-1).expand(B)
    lo = torch.zeros_like(cl)
    if window:
        lo = torch.maximum(lo, cl - window)
    if start is not None:
        lo = torch.maximum(lo, start.to(torch.int64).reshape(-1))
    return int((cl.clamp(max=S) - lo).clamp(min=0).sum())


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     start=None, lse: bool = False, use_kernels: bool = True):
    """q: [B,1,H,dh]; caches: [B,S,Hkv,dh]; cache_len: [B] or scalar.
    ``start`` ([B] ints or None) raises each slot's first row; ``lse=True``
    also returns the f32 log-sum-exp [B,H] of the scores attended (the
    sequence-sharded decode merges shards by it).  ``use_kernels=False``
    takes the plain version on any device."""
    with tracing.span("kernels.decode_attention"):
        if not (use_kernels and (q.is_cuda or q.is_meta)):
            return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                            window=window, start=start,
                                            lse=lse)
        B, _, H, dh = q.shape
        S, Hkv = k_cache.shape[1], k_cache.shape[2]

        def run():
            if q.is_meta:
                out = torch.empty(q.shape, dtype=v_cache.dtype,
                                  device=q.device)
                return (out, torch.empty((B, H), dtype=torch.float32,
                                         device=q.device)) if lse else out
            return decode_attention_cuda(q.contiguous(), k_cache, v_cache,
                                         cache_len, window=window,
                                         start=start, lse=lse)

        return costs.counted(
            "decode_attention", run, lambda _: costs.decode_attention(
                B, H, Hkv, dh,
                attended_rows(cache_len, start, window, B, S, q.device),
                k_cache.element_size(), start=start is not None, lse=lse))


def prefill_attention(q, k, v, *, causal: bool, window: int, q_positions,
                      kv_positions):
    """The prefill-attention kernel on q [B,Sq,H,dh], k [B,Sk,Hkv,dh] and v
    [B,Sk,Hkv,dv] (``chunked_attention``'s arguments), for a call the
    kernel takes (no ``prefill_attention.refusal``: the caller routes
    everything else to ``models/attention.py:chunked_attention``, its plain
    version)."""
    B, Sq, H, dh = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    return costs.counted(
        "prefill_attention",
        lambda: prefill_attention_cuda(q, k, v, causal=causal, window=window,
                                       q_positions=q_positions,
                                       kv_positions=kv_positions),
        lambda _: costs.prefill_attention(B, Sq, Sk, H, Hkv, dh, causal,
                                          window, q.element_size(), dv))


def mla_decode_attention(q, latent, cache_len, *, scale: float, v_dim: int,
                         use_kernels: bool = True):
    """q: [B,H,W] (an MLA decode's absorbed query); latent: [B,S,W];
    cache_len: [B] or scalar -> [B,H,v_dim]: each slot's valid rows as
    keys, their first ``v_dim`` values as values, at ``scale``.  The
    kernel where it takes the call (no ``mla_decode_attention.refusal``),
    else the plain version; ``use_kernels=False`` takes the plain version
    on any device."""
    if not use_kernels or mla_refusal(q, latent, v_dim) is not None:
        return ref.mla_decode_attention_ref(q, latent, cache_len, scale=scale,
                                            v_dim=v_dim)
    B, H, W = q.shape
    return costs.counted(
        "mla_decode_attention",
        lambda: mla_decode_attention_cuda(q.contiguous(), latent, cache_len,
                                          scale=scale),
        lambda _: costs.mla_decode_attention(
            B, H, W, v_dim, attended_rows(cache_len, None, 0, B,
                                          latent.shape[1], q.device),
            latent.element_size()))


def masked_compact(tokens, mask, capacity: int, *, use_kernels: bool = True):
    """tokens: [B,S,D]; mask: [B,S] bool -> (out [B,K,D], idx [B,K], count [B]).
    ``use_kernels=False`` takes the plain version on any device."""
    if not (use_kernels and (tokens.is_cuda or tokens.is_meta)):
        return ref.masked_compact_ref(tokens, mask, capacity)
    B, S, D = tokens.shape
    K = int(capacity)

    def run():
        if tokens.is_meta:
            return (torch.empty((B, K, D), dtype=tokens.dtype, device="meta"),
                    torch.empty((B, K), dtype=torch.int32, device="meta"),
                    torch.empty((B,), dtype=torch.int32, device="meta"))
        return masked_compact_cuda(tokens, mask, capacity)

    def cost(outs):      # the rows kept: the count the kernel wrote
        kept = None if tokens.is_meta else int(outs[2].sum())
        return costs.masked_compact(B, S, D, K, tokens.element_size(), kept)

    return costs.counted("masked_compact", run, cost)


def grouped_ffn(buf, wg, wu, wd, *, counts=None, use_kernels: bool = True):
    """buf: [E,C,D]; wg/wu: [E,D,F]; wd: [E,F,D] -> [E,C,D] in buf's dtype.
    ``counts``: None or int32 [E] on buf's device, the leading rows of each
    ``buf[e]`` in use (the rest are taken as zeros and give zero rows).
    ``use_kernels=False`` takes the plain version on any device.
    Differentiable in buf and the weights."""
    check_counts(counts, buf.shape[0], buf.device)
    return GroupedFFN.apply(buf, wg, wu, wd, counts, bool(use_kernels))


def grouped_ffn_sorted(xs, wg, wu, wd, offsets):
    """xs: [R,D] rows sorted by expert; wg/wu: [E,D,F]; wd: [E,F,D];
    offsets: int32 [E+1], expert e's rows ``offsets[e] <= r < offsets[e+1]``
    -> ys [R,D] in xs' dtype.  The kernel for CUDA tensors (the caller,
    ``models/moe.py:sorted_route``, sends only calls it takes), the plain
    version elsewhere.  Not differentiable."""
    if not xs.is_cuda:
        return ref.grouped_ffn_sorted_ref(xs, wg, wu, wd, offsets)
    E, D, F = wg.shape

    def cost(_):     # the experts with a row: read back while counting
        used = int((offsets[1:] > offsets[:-1]).sum())
        return costs.grouped_ffn_sorted(xs.shape[0], E, D, F,
                                        xs.element_size(), experts_used=used)

    return costs.counted(
        "grouped_ffn_sorted",
        lambda: grouped_ffn_sorted_cuda(xs, wg, wu, wd, offsets), cost)


def ssm_scan(decay, bx, h0, *, use_kernels: bool = True):
    """decay/bx: [B,S,di,N] f32; h0: [B,di,N] f32 -> (h_all [B,S,di,N],
    h_last [B,di,N]), both f32.  ``use_kernels=False`` takes the plain
    version on any device (forward and backward).  Differentiable in all
    three inputs."""
    return SSMScan.apply(decay, bx, h0, bool(use_kernels))


def admit_state(cur_tok, lengths, remaining, done, slot_ids, last_logits,
                prompt_lens, max_news, *, eos_id: int = -1):
    """Splice newly admitted requests into the decode-state vectors, in
    place: the [M] ``slot_ids`` being filled get the greedy first token of
    their prefill logits [M, V], their prompt length, their budget
    ``max_new - 1`` and ``done`` where the budget is spent or the first
    token is ``eos_id``.  Callers may pad the M entries to a fixed width by
    repeating the last real one: duplicate indices then carry identical
    values, so the writes are idempotent (on CUDA too).  Returns the four
    vectors and ``first`` [M], a tensor of its own (its host fetch may be
    deferred past later in-place updates of ``cur_tok``)."""
    first = last_logits.argmax(dim=-1).to(torch.int32)
    ids = slot_ids.long()
    cur_tok[ids] = first
    lengths[ids] = prompt_lens.to(lengths.dtype)
    remaining[ids] = (max_news - 1).to(remaining.dtype)
    done[ids] = (max_news <= 1) | (first == eos_id)
    return cur_tok, lengths, remaining, done, first


def admit_slots(cur_tok, lengths, remaining, done, slot_ids, last_logits,
                prompt_lens, max_news, *, eos_id: int = -1):
    """One admission phase's state scatter (the JAX package's donated
    standalone program); see :func:`admit_state`."""
    return admit_state(cur_tok, lengths, remaining, done, slot_ids,
                       last_logits, prompt_lens, max_news, eos_id=eos_id)


def splice_blocks(dst, src, slot_ids, shard=None, *, kv: bool = True):
    """Write M stacked prefill-cache blocks into M slots of a decode-cache
    leaf, in place.  ``dst`` is ``[L, B, ...]``; ``src`` is ``[L, M, ...]``
    whose trailing extents are at most dst's: each block lands at offset 0
    of every trailing axis (``[L, M, P, Hkv, dh]`` K/V rows fill the first
    P positions; same-shape leaves such as SSM states are replaced
    whole).  ``slot_ids`` [M] may repeat an index with identical blocks
    (the padding contract of :func:`admit_state`).  Returns ``dst``.

    On a mesh (``shard``, the :class:`~repro_torch.models.sharding.RankShard`
    of the decode cache) ``dst`` holds this rank's batch rows, and a K/V
    leaf (``kv``) its sequence rows [s0, s0 + S_loc): the rank takes the
    rows of the (replicated) source blocks it holds and writes the slots
    it holds, with no collective, as the JAX package's shard_map does.  A
    state or cross leaf (``kv=False``) has no sequence: its blocks land
    whole."""
    src = src.to(dst.dtype)
    if shard is not None:
        return _splice_local(dst, src, slot_ids, shard, kv)
    region = tuple(slice(0, n) for n in src.shape[2:])
    dst[(slice(None), slot_ids.long()) + region] = src
    return dst


def _splice_local(dst, src, slot_ids, shard, kv):
    rows = shard.held_rows(src.shape[2], kv)
    src = src[:, :, rows]
    if src.shape[2] == 0:
        return dst
    region = tuple(slice(0, n) for n in src.shape[2:])
    ids = slot_ids.long()
    if not shard.b_sharded:
        dst[(slice(None), ids) + region] = src
        return dst
    # slots are global: write only those on this rank's batch rows, one at
    # a time (a slot elsewhere rewrites a held slot with its own bytes)
    local = ids - shard.b0
    mine = (local >= 0) & (local < shard.B_loc)
    local = local.clamp(0, shard.B_loc - 1)
    for m in range(ids.shape[0]):
        at = (slice(None), local[m]) + region
        dst[at] = torch.where(mine[m], src[:, m], dst[at])
    return dst


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def count_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches, negative to take some back)
    to the wrappers' counts: the launches of a replayed CUDA graph, which
    runs no wrapper (``serving/decode_graph.py``)."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n
