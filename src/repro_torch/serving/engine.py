"""Serving engine: prefill + decode steps, batched greedy generation.

The JAX package's ``repro/serving/engine.py`` on PyTorch.
``make_decode_loop`` is the fused hot path: K decode steps per dispatch with
greedy sampling, per-slot lengths and eos detection all on the device; the
host fetches one ``[K, B]`` token block per macro-step.  On one CUDA
device with kernels on, its steps replay CUDA graphs that break at the
decode-attention calls (``serving/decode_graph.py``); elsewhere they run
eagerly.  Where JAX donates the cache and the decode-state vectors, the
port updates those tensors in place.  The per-slot ``lengths`` are the decode
``cache_index``, so on the fused path the decode-attention kernel is always
fed per-slot lengths.

``ServingEngine`` decodes one static batch.  ``ContinuousServingEngine`` is
the slot-based continuous-batching runtime: a request queue feeds a fixed
number of cache slots, every macro-step advances all slots with per-slot
cache indices, and finished requests are evicted and their slots refilled
at macro-step boundaries.  Its three schedules (per-step, boundary and
overlapped admission) emit the same token streams.  The overlapped one
prefills queued requests speculatively into shadow slots on a side CUDA
stream while the decode macro-step runs, launched from one worker thread;
with a ``prefill_worker`` those prefills go to the prefill group
(disaggregated prefill), and with a ``prefix_cache`` every admission reuses
cached prefix blocks.

Both engines serve on a mesh: constructed and run inside
``models.sharding.activation_sharding(mesh)`` on every rank, with
``launch.mesh.shard_params``' params, each rank holds its block of the
cache and runs the same host schedule.  The carried decode-state vectors
are replicated (broadcast from the mesh's first rank when they are made),
every step's logits come back whole to every rank, and every host decision
depends only on tokens and counts, so the ranks stay in step.  Collectives
go out from one thread in one order: on a mesh the decode macro-step
launches inline on the engine's thread instead of the decode-launch
worker.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.offload import tree_leaves, tree_map
from repro_torch.device import DeviceLike, resolve_device, synchronize, upload
from repro_torch.kernels import ops
from repro_torch.kernels.ops import resolve_use_kernels
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.models.attention import quantize_kv
from repro_torch.serving import decode_graph


def _use(use_kernels: Union[bool, str], t: torch.Tensor) -> bool:
    return resolve_use_kernels(use_kernels, t.device)


def make_prefill_step(cfg, *, use_kernels: Union[bool, str] = "auto"):
    """(params, batch) -> (last_logits [B,V], caches)."""
    def prefill_step(params, batch):
        with tracing.span("model.prefill"):
            out = M.forward(params, cfg, batch, mode="prefill",
                            use_kernels=_use(use_kernels, batch["tokens"]))
            return out.logits[:, -1], out.cache
    return prefill_step


def make_serve_step(cfg, *, use_kernels: Union[bool, str] = "auto"):
    """(params, cache, token [B,1], cache_index, shard=None) -> (logits
    [B,V], cache); the cache is updated in place.  ``shard``: the cache's
    block on a mesh (``model.cache_shard``)."""
    def serve_step(params, cache, token, cache_index, shard=None):
        with tracing.span("model.decode_step"):
            out = M.forward(params, cfg,
                            {"token": token, "cache": cache,
                             "cache_index": cache_index},
                            mode="decode",
                            use_kernels=_use(use_kernels, token), shard=shard)
            return out.logits[:, 0], out.cache
    return serve_step


def make_decode_loop(cfg, *, macro_steps: int, eos_id: Optional[int] = None,
                     use_kernels: Union[bool, str] = "auto"):
    """Fused K-token decode.

    ``(params, cache, cur_tok [B], lengths [B], remaining [B], done [B],
    shard=None) -> (tokens [K, B], cache, cur_tok, lengths, remaining,
    done)`` (``shard``: the cache's block on a mesh)

    Each step runs one decode step for every slot, takes the greedy argmax
    on the device (first index on ties), and advances only the live slots:
    a slot freezes the step it emits its ``remaining``-th token or
    ``eos_id``.  Frozen slots keep executing with junk inputs; the per-slot
    length masks isolate their cache rows.  The cache and the four state
    vectors are updated in place (the JAX loop donates them) and returned.
    Where ``decode_graph.decode_graph_refusal`` names no reason the steps
    replay CUDA graphs of one step (``serving/decode_graph.py``), else they
    run eagerly; the loop's ``graphs`` counts both.
    """
    eos = -1 if eos_id is None else int(eos_id)

    def step(params, cache, cur_tok, lengths, remaining, done, shard=None,
             kern=True):
        out = M.forward(params, cfg,
                        {"token": cur_tok[:, None], "cache": cache,
                         "cache_index": lengths},
                        mode="decode", use_kernels=kern, shard=shard)
        new_tok = out.logits[:, 0].argmax(dim=-1).to(torch.int32)
        active = ~done
        adv = active.to(torch.int32)
        cur_tok.copy_(torch.where(active, new_tok, cur_tok))
        lengths += adv
        remaining -= adv
        done |= active & ((remaining <= 0) | (cur_tok == eos))

    graphs = decode_graph.DecodeGraphs(step)

    def decode_loop(params, cache, cur_tok, lengths, remaining, done,
                    shard=None):
        kern = _use(use_kernels, cur_tok)
        if decode_graph.decode_graph_refusal(cur_tok, kern) is None:
            toks = graphs.run(macro_steps, params, cache, cur_tok, lengths,
                              remaining, done)
            return toks, cache, cur_tok, lengths, remaining, done
        toks = torch.empty((macro_steps, cur_tok.shape[0]), dtype=torch.int32,
                           device=cur_tok.device)
        for i in range(macro_steps):
            with tracing.span("model.decode_step"):
                step(params, cache, cur_tok, lengths, remaining, done, shard,
                     kern)
                toks[i] = cur_tok
        graphs.eager_steps += macro_steps
        return toks, cache, cur_tok, lengths, remaining, done

    decode_loop.graphs = graphs
    return decode_loop


def make_wave_driver(cfg, *, macro_steps: int, wave_steps: int,
                     eos_id: Optional[int] = None,
                     use_kernels: Union[bool, str] = "auto"):
    """M fused K-token macro-steps per call, one token block for all:

    ``(params, cache, cur_tok, lengths, remaining, done, shard=None)
    -> (tokens [M, K, B], cache, cur_tok, lengths, remaining, done)``

    Slots that finish mid-wave freeze exactly as they do mid-macro-step,
    so the streams equal the single-step driver's.  Updates its arguments
    in place like :func:`make_decode_loop`."""
    loop = make_decode_loop(cfg, macro_steps=macro_steps, eos_id=eos_id,
                            use_kernels=use_kernels)

    def wave_driver(params, cache, cur_tok, lengths, remaining, done,
                    shard=None):
        toks = torch.empty((wave_steps, macro_steps, cur_tok.shape[0]),
                           dtype=torch.int32, device=cur_tok.device)
        for m in range(wave_steps):
            toks[m], cache, cur_tok, lengths, remaining, done = loop(
                params, cache, cur_tok, lengths, remaining, done, shard)
        return toks, cache, cur_tok, lengths, remaining, done

    wave_driver.graphs = loop.graphs
    return wave_driver


def _macro_step(fn, args, parent: Optional[int] = None):
    """One launch of a fused decode program under its span (``parent``:
    the submitting thread's span, when it runs on the launcher thread)."""
    with tracing.span("engine.macro_step", parent=parent):
        return fn(*args)


class _DecodeLauncher:
    """One background thread that launches the fused decode programs.

    ``submit`` returns a future at once, so ``t_dispatch_s`` is the submit
    cost and the macro-step's launch and device work land in ``t_await_s``
    at ``Future.result()``, while the caller's thread queues shadow
    prefills behind it.  The first submit of each program runs inline on
    the caller's thread and returns the bare result (callers treat a
    future-less return as complete), as in the JAX engine.

    PyTorch keeps the current device, the current stream and grad mode per
    thread: the worker sets the engine's device once and launches each
    program under ``no_grad`` on the stream that was current on the
    submitting thread, so every decode step of the engine (and every
    decode_attention split ticket, keyed by device and stream) stays on
    the one decode stream.

    On a mesh every submit runs inline: the macro-step's collectives must go
    out from the thread that issues the shadow prefills' collectives, in one
    order on every rank."""

    def __init__(self, device: torch.device):
        self._device = device
        self._pool: Optional[ThreadPoolExecutor] = None
        self._warm: set = set()

    def _enter_device(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)

    @staticmethod
    def _launch(stream, fn, args, parent=None):
        with torch.no_grad(), torch.cuda.stream(stream):
            return _macro_step(fn, args, parent)

    def submit(self, fn, *args):
        if sharding.active_mesh() is not None:
            return _macro_step(fn, args)
        if id(fn) not in self._warm:
            self._warm.add(id(fn))
            return _macro_step(fn, args)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="decode-launch",
                initializer=self._enter_device)
        stream = torch.cuda.current_stream(self._device) \
            if self._device.type == "cuda" else None
        return self._pool.submit(self._launch, stream, fn, args,
                                 tracing.current())


# ---------------------------------------------------------------------------
def seed_cache(cfg, big_cache, prefill_cache, prefill_len: int, shard=None):
    """Copy the prefill caches into the full-size decode buffers, in place,
    leaf by leaf over every cache family (dicts of K/V, tuples of SSM
    states, the audio decoder's cross K/V): each prefill leaf is written at
    offset 0 of axis 2.  For the length-P K/V buffers that is the first P
    positions; for same-shape leaves (the conv and SSM states, the cross
    K/V) it replaces the whole leaf.  An int8 destination takes the
    quantized prefill K/V and their scales.  On a mesh (``shard`` of the
    decode cache) both hold this rank's batch rows, and the rank copies the
    prefill rows it holds (``RankShard.held_rows``: a K/V leaf's sequence
    shard, all of a state or cross leaf)."""
    def upd(dst, src, kv):
        rows = slice(0, src.shape[2]) if shard is None \
            else shard.held_rows(src.shape[2], kv)
        n = rows.stop - rows.start
        dst[:, :, :n].copy_(src[:, :, rows])
        return dst
    return _merge_cache(cfg, big_cache, prefill_cache, upd)


# ---------------------------------------------------------------------------
@dataclass
class GenerationResult:
    tokens: np.ndarray            # [B, max_new]
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    host_syncs: int = 0           # device->host materializations
    t_per_macro_step_s: float = 0.0   # decode wall per fused dispatch (0.0
                                      # on the per-step macro_steps=0 path)


class ServingEngine:
    """Batched greedy generation with a fixed-capacity KV cache.

    ``macro_steps=K`` (default 8) decodes in fused K-token dispatches
    (:func:`make_decode_loop`); ``macro_steps=0`` keeps the per-token host
    loop (one host sync per token).  Both emit identical tokens.  Runs on
    the card unless ``device`` says otherwise; ``decode_steps`` counts the
    model decode steps run (every layer of each one calls decode
    attention)."""

    def __init__(self, cfg, params, *, max_len: int = 512,
                 use_kernels: Union[bool, str] = "auto",
                 macro_steps: int = 8, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self.macro_steps = int(macro_steps)
        self._use_kernels = resolve_use_kernels(use_kernels, self.device)
        self.prefill = make_prefill_step(cfg, use_kernels=self._use_kernels)
        self.step = make_serve_step(cfg, use_kernels=self._use_kernels)
        # one fused loop for every generate call: its graphs outlive a call
        self._loop = make_decode_loop(cfg, macro_steps=self.macro_steps,
                                      use_kernels=self._use_kernels) \
            if self.macro_steps > 0 else None
        self.decode_steps = 0

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new: int = 16,
                 frontend: Optional[np.ndarray] = None) -> GenerationResult:
        """prompts: [B, P] int32 (pre-padded); ``frontend`` [B, F, fd] for
        the vlm and audio families (the vlm's cache holds its F patch rows
        ahead of the prompt, so ``max_len`` counts them)."""
        cfg, dev = self.cfg, self.device
        B, P = prompts.shape
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=dev)}
        if frontend is not None:
            batch["frontend"] = upload(np.asarray(frontend, np.float32), dev)
        rows = P + M.frontend_offset(cfg)
        t0 = time.perf_counter()
        last_logits, pre_cache = self.prefill(self.params, batch)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0

        cache = M.init_cache(cfg, B, self.max_len, dtype=cfg.torch_dtype,
                             device=dev)
        shard = M.cache_shard(cfg, B, self.max_len)
        cache = seed_cache(cfg, cache, pre_cache, rows, shard)
        del pre_cache

        if self.macro_steps == 0:
            return self._generate_per_step(last_logits, cache, rows, max_new,
                                           t_prefill, shard)

        K, loop = self.macro_steps, self._loop
        tok = last_logits.argmax(dim=-1).to(torch.int32)
        lengths = torch.full((B,), rows, dtype=torch.int32, device=dev)
        remaining = torch.full((B,), max_new - 1, dtype=torch.int32, device=dev)
        done = remaining <= 0
        # a copy: on the CPU .numpy() would alias tok, which the loop
        # updates in place
        out_toks = [np.array(tok.cpu())[:, None]]
        host_syncs = 1
        dispatches = 0
        need = max_new - 1
        t0 = time.perf_counter()
        while need > 0:
            toks, cache, tok, lengths, remaining, done = loop(
                self.params, cache, tok, lengths, remaining, done, shard)
            t = toks.cpu().numpy()        # the macro-step's ONE host sync
            host_syncs += 1
            dispatches += 1
            self.decode_steps += K
            take = min(need, K)
            out_toks.append(t[:take].T)
            need -= take
        t_decode = time.perf_counter() - t0
        toks = np.concatenate(out_toks, axis=1)
        return GenerationResult(
            tokens=toks, prefill_s=t_prefill, decode_s=t_decode,
            tokens_per_s=B * max_new / max(t_decode + t_prefill, 1e-9),
            host_syncs=host_syncs,
            t_per_macro_step_s=t_decode / max(dispatches, 1))

    def _generate_per_step(self, last_logits, cache, idx: int, max_new: int,
                           t_prefill: float, shard=None) -> GenerationResult:
        """Per-token host loop: one dispatch + one host sync per token."""
        tok = last_logits.argmax(dim=-1)[:, None].to(torch.int32)
        out_toks = [tok.cpu().numpy()]
        host_syncs = 1
        # device-resident position counter: one upload, then it advances
        # on the device
        idx_dev = torch.tensor(idx, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            logits, cache = self.step(self.params, cache, tok, idx_dev, shard)
            tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
            out_toks.append(tok.cpu().numpy())
            host_syncs += 1
            self.decode_steps += 1
            idx_dev = idx_dev + 1
        t_decode = time.perf_counter() - t0
        toks = np.concatenate(out_toks, axis=1)
        return GenerationResult(
            tokens=toks, prefill_s=t_prefill, decode_s=t_decode,
            tokens_per_s=toks.size / max(t_decode + t_prefill, 1e-9),
            host_syncs=host_syncs)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------
def _merge_cache(cfg, big_cache, prefill_cache, upd):
    """Walk the decode-cache tree, applying ``upd(dst_leaf, src_leaf, kv)``
    at every leaf and quantizing the prefill K/V into int8 destinations on
    the way: dense and MoE ``{"self": kv}``, the audio decoder's ``"cross"``
    K/V (never quantized), SSM ``(conv, ssm)`` tuples and the hybrid
    ``{"backbone", "shared"}``.  ``kv`` tells a self-attention K/V leaf
    (whose sequence a mesh may shard) from a state or cross leaf (which has
    none).  Shared by seeding, the per-slot write and the fused splice --
    only the leaf update differs."""
    def states(dst, src):
        return tree_map(lambda d, s: upd(d, s, False), dst, src)

    def copy_kv(dst, src):
        if "self" in dst:            # unwrap {"self": ...} wrappers
            return {key: copy_kv(dst[key], src[key]) for key in dst}
        if "k_scale" in dst and "k_scale" not in src:
            out = {}
            for name in ("k", "v"):
                qt, sc = quantize_kv(src[name])
                out[name] = upd(dst[name], qt, True)
                out[name + "_scale"] = upd(dst[name + "_scale"], sc, True)
            return out
        return tree_map(lambda d, s: upd(d, s, True), dst, src)

    kind = M._kind(cfg)
    if kind == "ssm":
        return states(big_cache, prefill_cache)
    if kind == "hybrid":
        return {"backbone": states(big_cache["backbone"],
                                   prefill_cache["backbone"]),
                "shared": copy_kv(big_cache["shared"], prefill_cache["shared"])}
    out = {"self": copy_kv(big_cache["self"], prefill_cache["self"])}
    if "cross" in big_cache:
        out["cross"] = states(big_cache["cross"], prefill_cache["cross"])
    return out


def write_slot_cache(cfg, big_cache, prefill_cache, slot, shard=None):
    """Write a B=1 prefill cache into slot ``slot`` of the big decode cache,
    in place.  Every leaf is ``[L, B, ...]`` and the prefill leaf ``[L, 1,
    P, ...]`` (or ``[L, 1, ...]`` for SSM states; the cross K/V's ``[L, 1,
    F, ...]`` replaces the slot's whole leaf); positions past the prompt
    keep the slot's previous occupant's bytes, which the per-slot length
    masks hide.  Routes through ``ops.splice_blocks`` with a
    one-element slot vector, as the JAX engine does (``shard``: the decode
    cache's on a mesh)."""
    dev = tree_leaves(big_cache)[0].device
    ids = torch.full((1,), int(slot), dtype=torch.int32, device=dev)
    return _merge_cache(cfg, big_cache, prefill_cache,
                        lambda d, s, kv: ops.splice_blocks(d, s, ids, shard,
                                                           kv=kv))


def stack_prefill_blocks(caches):
    """Stack M B=1 prefill caches on the slot axis (axis 1, after the
    layer axis) into the ``blocks`` tree :func:`splice_slot_caches` takes."""
    return tree_map(lambda *xs: torch.cat(xs, dim=1), *caches)


def splice_slot_caches(cfg, big_cache, blocks, slot_ids, shard=None):
    """Write M B=1 prefill caches (a list, or a tree stacked on axis 1)
    into slots ``slot_ids`` [M] of the big decode cache, in place: the
    cross-group splice of disaggregated prefill (``shard``: the decode
    cache's on a mesh).  A list goes in block by block, never stacked
    into one more copy of all M blocks (13.3 GiB at 64 slots of
    7,168-token latent rows); a stacked tree in one pass over its
    leaves."""
    if isinstance(blocks, (list, tuple)):
        for m, block in enumerate(blocks):
            big_cache = _merge_cache(
                cfg, big_cache, block,
                lambda d, s, kv: ops.splice_blocks(d, s, slot_ids[m:m + 1],
                                                   shard, kv=kv))
        return big_cache
    return _merge_cache(cfg, big_cache, blocks,
                        lambda d, s, kv: ops.splice_blocks(d, s, slot_ids,
                                                           shard, kv=kv))


def admit_boundary(cfg, big_cache, blocks, slot_ids, cur_tok, lengths,
                   remaining, done, last_logits, prompt_lens, max_news,
                   *, eos_id: int = -1, shard=None):
    """A whole admission boundary: splice the admitted blocks into the big
    cache (:func:`splice_slot_caches`) and scatter the four decode-state
    vectors (``ops.admit_state``), all in place.  Every vector and the
    block list are padded to the slot width by repeating the last real
    entry (identical duplicate writes).  Returns ``(cache, cur_tok,
    lengths, remaining, done, first)``."""
    cache = splice_slot_caches(cfg, big_cache, blocks, slot_ids, shard)
    cur_tok, lengths, remaining, done, first = ops.admit_state(
        cur_tok, lengths, remaining, done, slot_ids, last_logits,
        prompt_lens, max_news, eos_id=eos_id)
    return cache, cur_tok, lengths, remaining, done, first


@dataclass
class ServeRequest:
    """One unit of work for the continuous-batching queue."""
    uid: int
    prompt: np.ndarray                 # [P] int32 (padded to the engine's P)
    max_new: int
    frontend: Optional[np.ndarray] = None
    task: str = ""                     # HeteroRuntime registry key ("" =
                                       # sole registered task)


@dataclass
class RequestOutput:
    uid: int
    tokens: np.ndarray                 # [n_generated] int32
    admitted_step: int
    finished_step: int


@dataclass
class ContinuousStats:
    requests: int
    total_tokens: int
    decode_steps: int
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    occupancy: float                   # mean fraction of busy slots per step
    host_syncs: int = 0                # device->host reads (one per macro-
                                       # step + one per admission phase;
                                       # per token when macro_steps=0)
    macro_dispatches: int = 0          # fused K-token macro-steps executed
                                       # (wave launches count M each)
    wave_launches: int = 0             # launches of the fused decode driver
    t_per_macro_step_s: float = 0.0    # decode wall per fused dispatch
    t_prefill_overlap_s: float = 0.0   # host wall dispatching shadow
                                       # prefills behind the in-flight
                                       # macro-step (off the critical path)
    admission_stalls: int = 0          # boundaries where live slots waited
                                       # on a prefill
    shadow_prefills: int = 0           # speculative prefills dispatched
    prefill_offloaded: int = 0         # shadows sent to the prefill group
    t_kv_transfer_s: float = 0.0       # priced KV-transfer hop total
    prefill_fallbacks: int = 0         # prefill-group failures recovered
                                       # by local shadow prefill
    # on the fused paths decode_s == t_dispatch_s + t_await_s exactly; all
    # four stay 0.0 on the per-step path
    t_splice_s: float = 0.0            # wall of the fused cross-group
                                       # splice (disaggregated boundaries)
    t_slot_write_s: float = 0.0        # wall of the per-slot cache writes
    t_dispatch_s: float = 0.0          # wall submitting decode macro-steps
    t_await_s: float = 0.0             # wall blocked on the token block
    prefix_hits: int = 0               # requests that reused >= 1 cached
                                       # prefix block (full hits included)
    prefix_blocks_reused: int = 0      # cached KV blocks reused
    prefill_flops_avoided: float = 0.0  # analytic prefill FLOPs skipped
    prefill_flops_total: float = 0.0   # ... and what no cache would cost
    kv_hop_bytes_raw: float = 0.0      # prefill->decode KV bytes before
                                       # sender-side compaction
    kv_hop_bytes_wire: float = 0.0     # ... and what crossed the link
    # model decode steps of the fused loop (K a macro-step), replayed as
    # CUDA graphs or run eagerly (refused, or the eager step before a
    # capture), and the captures made (serving/decode_graph.py)
    decode_graph_steps: int = 0
    decode_eager_steps: int = 0
    decode_graph_captures: int = 0


@dataclass
class _Shadow:
    """One in-flight speculative prefill (shadow slot)."""
    req: ServeRequest
    logits: Any                        # last-token logits
    cache: Any                         # B=1 prefill cache; None for
                                       # single-token requests
    remote: bool = False               # lives on the prefill group until
                                       # fetched
    hit: Any = None                    # PrefixHit behind a resumed remote
                                       # prefill (its prefix and pins)
    ready: Any = None                  # CUDA event on the side stream
                                       # after the shadow's last work


@dataclass
class _Slot:
    uid: int = -1
    remaining: int = 0
    tokens: List[int] = field(default_factory=list)
    admitted_step: int = 0
    finished_at: int = -1              # micro-step the last token landed
                                       # on (eviction may lag)

    @property
    def busy(self) -> bool:
        return self.uid >= 0


def _fetch(t: torch.Tensor) -> np.ndarray:
    """One host read (a host sync on the card)."""
    return t.cpu().numpy()


class ContinuousServingEngine:
    """Slot-based continuous batching with greedy decoding.

    A fixed ``slots``-wide decode batch; requests are admitted into free
    slots (a B=1 prefill written into the slot's cache rows), every
    macro-step advances all slots up to ``macro_steps`` tokens with
    per-slot cache indices, and finished requests are evicted at the next
    boundary.  Streams equal static batching's and the per-step loop's:
    each slot attends only to its own positions, so a frozen slot decoding
    junk until the boundary cannot reach a live one.

    The decode state (``cur_tok`` / ``lengths`` / ``remaining`` /
    ``done``) stays on the device; the host reads one ``[K, slots]`` token
    block per macro-step and one first-token block per admission phase.
    ``macro_steps=0`` keeps the per-token host loop.  ``overlap_admission``
    (the default on the fused path) runs the speculative shadow-slot
    schedule; ``wave_steps=M`` runs M macro-steps per launch;
    ``async_dispatch`` launches them from a worker thread.

    ``prefill_worker`` (a :class:`repro_torch.serving.prefill.PrefillWorker`
    or pool) takes the shadow prefills on the overlapped path and sends
    their blocks back over its priced hop; if it fails the engine falls back
    to local shadow prefill with the same streams.  ``prefix_cache`` (a
    :class:`repro_torch.serving.prefix_cache.PrefixCache`) is consulted
    before every prefill: exact full hits skip prefill (and the hop),
    partial hits resume from the cached blocks.  ``share_from``: a sibling
    engine whose decode programs this one reuses when both have the same
    cfg, device and kernel setting (else it builds its own).  Runs
    on the card unless ``device`` says otherwise."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 512,
                 use_kernels: Union[bool, str] = "auto",
                 eos_id: Optional[int] = None,
                 macro_steps: int = 8,
                 wave_steps: int = 1,
                 overlap_admission: bool = True,
                 async_dispatch: bool = True,
                 prefill_worker: Optional[Any] = None,
                 prefix_cache: Optional[Any] = None,
                 share_from: Optional["ContinuousServingEngine"] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.prefix_cache = prefix_cache
        self.slots, self.max_len, self.eos_id = slots, max_len, eos_id
        self.macro_steps = int(macro_steps)
        self.wave_steps = int(wave_steps)
        if self.wave_steps < 1:
            raise ValueError(f"wave_steps must be >= 1, got {wave_steps}")
        if self.wave_steps > 1 and self.macro_steps == 0:
            raise ValueError("wave_steps > 1 needs the fused decode path "
                             "(macro_steps > 0)")
        self.async_dispatch = bool(async_dispatch)
        self.overlap_admission = bool(overlap_admission)
        self.prefill_worker = prefill_worker
        if prefill_worker is not None and (
                self.macro_steps == 0 or not self.overlap_admission):
            raise ValueError(
                "disaggregated prefill (prefill_worker=) requires the "
                "overlapped fused path: macro_steps > 0 and "
                "overlap_admission=True")
        self.prefill_remote = prefill_worker is not None
        self._use_kernels = resolve_use_kernels(use_kernels, self.device)
        if share_from is not None and share_from.cfg is cfg \
                and share_from.device == self.device \
                and share_from._use_kernels == self._use_kernels:
            self.prefill = share_from.prefill
            self.step = share_from.step
            self._loops = share_from._loops
            self._waves = share_from._waves
        else:
            self.prefill = make_prefill_step(cfg, use_kernels=self._use_kernels)
            self.step = make_serve_step(cfg, use_kernels=self._use_kernels)
            self._loops: Dict[Tuple[int, Optional[int]], Any] = {}
            self._waves: Dict[Tuple[int, int, Optional[int]], Any] = {}
        self._on_tokens: Optional[Callable[[int, int, List[int]], None]] = None
        self._launcher = _DecodeLauncher(self.device) \
            if self.async_dispatch else None
        # the overlapped schedule's shadow work runs on its own stream
        self._side = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._offset = M.frontend_offset(cfg)   # the vlm's prologue rows
        # the decode cache's block on the mesh the engine is built under
        self._shard = M.cache_shard(cfg, slots, max_len)

    def _get_loop(self, K: int):
        key = (K, self.eos_id)
        if key not in self._loops:
            self._loops[key] = make_decode_loop(
                self.cfg, macro_steps=K, eos_id=self.eos_id,
                use_kernels=self._use_kernels)
        return self._loops[key]

    def _get_wave(self, K: int, W: int):
        key = (K, W, self.eos_id)
        if key not in self._waves:
            self._waves[key] = make_wave_driver(
                self.cfg, macro_steps=K, wave_steps=W, eos_id=self.eos_id,
                use_kernels=self._use_kernels)
        return self._waves[key]

    def _fused(self):
        """The fused decode program of this engine's K and W."""
        K, W = self.macro_steps, self.wave_steps
        return self._get_wave(K, W) if W > 1 else self._get_loop(K)

    # ------------------------------------------------------------------
    def _make_batch(self, req: ServeRequest):
        """The host-side (numpy) batch: the prefill uploads it, and the
        prefill pool's affinity key hashes the prompt without a device
        read."""
        batch = {"tokens": np.asarray(req.prompt)[None]}
        if req.frontend is not None:
            batch["frontend"] = np.asarray(req.frontend, np.float32)[None]
        return batch

    def _prefill(self, batch):
        dev_batch = {k: upload(batch[k], self.device)
                     for k in ("tokens", "frontend") if k in batch}
        if "prefix" in batch:
            dev_batch["prefix"] = batch["prefix"]
        return self.prefill(self.params, dev_batch)

    def _account_hit(self, hit) -> None:
        """Fold one PrefixHit (hit or miss) into the run's counters."""
        if hit.hit:
            self._pc_hits += 1
            self._pc_blocks += hit.blocks
        self._pc_flops_avoided += hit.flops_avoided
        self._pc_flops_total += hit.flops_total

    def _prefill_via_cache(self, req: ServeRequest):
        """B=1 local prefill through the prefix cache: an exact full hit
        skips the prefill, a partial hit resumes from the cached span, and
        whatever was prefilled is indexed before the caller consumes it."""
        pc = self.prefix_cache
        batch = self._make_batch(req)
        if pc is None:
            return self._prefill(batch)
        hit = pc.match(req.prompt, frontend=req.frontend)
        self._account_hit(hit)
        if hit.full is not None:
            return hit.full
        if hit.prefix is not None:
            batch = dict(batch, prefix=hit.prefix)
        logits, cache = self._prefill(batch)
        pc.insert(req.prompt, logits, cache, frontend=req.frontend)
        pc.release(hit)
        return logits, cache

    # ------------------------------------------------------------------
    def _emit_tokens(self, uid: int, start: int, toks) -> None:
        """Stream host-landed tokens to the run's ``on_tokens`` hook as
        ``(uid, absolute position of toks[0], tokens)``."""
        if self._on_tokens is not None and len(toks):
            self._on_tokens(uid, start, [int(t) for t in toks])

    def _consume_block(self, block, slot_states, K: int,
                       step_no: int) -> Tuple[int, float]:
        """Host bookkeeping for one fetched ``[K, slots]`` token block,
        mirroring the device's freeze logic: each live slot takes tokens
        until its budget runs out or eos lands.  Returns (steps used, busy
        occupancy increment)."""
        eos = self.eos_id
        consumed = np.zeros((self.slots,), np.int64)
        for i, s in enumerate(slot_states):
            if not s.busy or s.remaining <= 0 or (
                    eos is not None and s.tokens and s.tokens[-1] == eos):
                continue
            col = block[:min(s.remaining, K), i]
            if eos is not None:
                hits = np.nonzero(col == eos)[0]
                if hits.size:
                    col = col[:hits[0] + 1]
            s.tokens.extend(int(x) for x in col)
            self._emit_tokens(s.uid, len(s.tokens) - len(col), col)
            s.remaining -= len(col)
            consumed[i] = len(col)
            if s.remaining <= 0 or (eos is not None and s.tokens[-1] == eos):
                s.finished_at = step_no + len(col)
        steps_used = int(consumed.max())
        busy_inc = sum(float((consumed > j).sum()) / self.slots
                       for j in range(steps_used))
        return steps_used, busy_inc

    # ------------------------------------------------------------------
    def _pad_admit_args(self, entries):
        """The fixed-width admission vectors for ``entries`` (a list of
        ``(slot, req, last_logits)``), padded to the slot count by
        repeating the last real entry.  Returns ``(slot_ids [slots],
        logits [slots, V], prompt_lens [slots], max_news [slots])``."""
        pad = self.slots - len(entries)
        ids = [e[0] for e in entries] + [entries[-1][0]] * pad
        logits = [e[2] for e in entries] + [entries[-1][2]] * pad
        plens = [len(e[1].prompt) + self._offset for e in entries]
        plens += [plens[-1]] * pad
        mnews = [e[1].max_new for e in entries]
        mnews += [mnews[-1]] * pad
        vec = lambda v: upload(np.asarray(v, np.int32), self.device)  # noqa: E731
        return vec(ids), torch.cat(logits, dim=0), vec(plens), vec(mnews)

    def _per_step_advance(self, cache, cur_tok, lengths, done):
        """One ``macro_steps=0`` decode step with the state advance on the
        device: greedy-argmax the next token, move only the live slots, and
        read the token vector -- the step's one host sync."""
        logits, cache = self.step(self.params, cache, cur_tok[:, None], lengths,
                                  self._shard)
        new_tok = logits.argmax(dim=-1).to(torch.int32)
        adv = ~done
        cur_tok = torch.where(adv, new_tok, cur_tok)
        lengths = lengths + adv.to(lengths.dtype)
        return cache, cur_tok, lengths, _fetch(new_tok)

    def _admit_free_slots(self, pending, slot_states, cache, cur_tok,
                          lengths, remaining, done, step_no: int):
        """Admit queued requests into every free slot: all prefills and
        slot writes first, then one padded ``admit_slots`` and one read of
        the admitted slots' first tokens.  Returns the state, the host
        syncs made and the wall spent in the slot writes."""
        admitted = []
        t_write = 0.0
        for slot, s in enumerate(slot_states):
            if not s.busy and pending:
                req = pending.popleft()
                with tracing.span("engine.prefill", req.uid, exposed=True):
                    last_logits, pre_cache = self._prefill_via_cache(req)
                with tracing.timed("engine.splice") as sp:
                    cache = write_slot_cache(self.cfg, cache, pre_cache, slot,
                                             self._shard)
                t_write += sp.seconds
                admitted.append((slot, req, last_logits))
        syncs = 0
        if admitted:
            ids, logits, plens, mnews = self._pad_admit_args(admitted)
            cur_tok, lengths, remaining, done, first_dev = ops.admit_slots(
                cur_tok, lengths, remaining, done, ids, logits, plens, mnews,
                eos_id=-1 if self.eos_id is None else int(self.eos_id))
            firsts = _fetch(first_dev)
            syncs = 1
            for (slot, req, _), first in zip(admitted, firsts):
                slot_states[slot] = _Slot(
                    uid=req.uid, remaining=req.max_new - 1,
                    tokens=[int(first)], admitted_step=step_no)
                self._emit_tokens(req.uid, 0, [int(first)])
        return cache, cur_tok, lengths, remaining, done, syncs, t_write

    def _init_state(self):
        """Fresh decode state (``done`` marks free slots) and big cache (on
        a mesh: the rank's block, and the state replicated from the mesh's
        first rank).  Where the fused loop replays graphs the cache is the
        loop's own, zeroed (``DecodeGraphs.cache``): the engines sharing
        the loop run in turn on one cache at the graphs' addresses."""
        dev, n = self.device, self.slots
        zeros = lambda: torch.zeros((n,), dtype=torch.int32, device=dev)  # noqa: E731
        lengths, cur_tok, remaining = zeros(), zeros(), zeros()
        done = torch.ones((n,), dtype=torch.bool, device=dev)
        sharding.replicate((cur_tok, lengths, remaining, done))

        def make():
            return M.init_cache(self.cfg, n, self.max_len,
                                dtype=self.cfg.torch_dtype, device=dev)

        if self.macro_steps > 0 and decode_graph.decode_graph_refusal(
                cur_tok, self._use_kernels) is None:
            cache = self._fused().graphs.cache((n, self.max_len), make)
        else:
            cache = make()
        return cache, cur_tok, lengths, remaining, done

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self, requests: Sequence[ServeRequest],
            on_tokens: Optional[Callable[[int, int, List[int]], None]] = None
            ) -> Tuple[List[RequestOutput], ContinuousStats]:
        self._on_tokens = on_tokens
        if not requests:
            return [], ContinuousStats(0, 0, 0, 0.0, 0.0, 0.0, 0.0)
        P = len(requests[0].prompt)
        if not all(len(r.prompt) == P for r in requests):
            raise ValueError("pad prompts to a common length before "
                             "submission")
        if not all(r.max_new >= 1 for r in requests):
            raise ValueError("every request needs max_new >= 1")
        if P + self._offset + max(r.max_new for r in requests) > self.max_len:
            raise ValueError("max_len too small for prompt + generation")
        # this run's prefix-cache / KV-hop deltas (the cache is shared)
        self._pc_hits = self._pc_blocks = 0
        self._pc_flops_avoided = self._pc_flops_total = 0.0
        self._kv_raw = self._kv_wire = 0.0
        graphs = self._fused().graphs if self.macro_steps > 0 else None
        mark = graphs.counts() if graphs is not None else {}
        with tracing.span("engine.run"):
            if self.macro_steps > 0 and self.overlap_admission:
                outputs, stats = self._run_overlapped(requests)
            else:
                outputs, stats = self._run_boundary(requests)
        if graphs is not None:
            stats = replace(stats, **{
                k: n - mark[k] for k, n in graphs.counts().items()})
        return outputs, stats

    def _stats(self, outputs, step_no, busy_acc, t_prefill, t_decode,
               wall, **kw) -> ContinuousStats:
        total_tokens = sum(len(o.tokens) for o in outputs)
        dispatches = kw.get("macro_dispatches", 0)
        return ContinuousStats(
            requests=len(outputs), total_tokens=total_tokens,
            decode_steps=step_no, prefill_s=t_prefill, decode_s=t_decode,
            tokens_per_s=total_tokens / max(wall, 1e-9),
            occupancy=busy_acc / max(step_no, 1),
            t_per_macro_step_s=t_decode / max(dispatches, 1) if dispatches
            else 0.0,
            prefix_hits=self._pc_hits,
            prefix_blocks_reused=self._pc_blocks,
            prefill_flops_avoided=self._pc_flops_avoided,
            prefill_flops_total=self._pc_flops_total,
            kv_hop_bytes_raw=self._kv_raw, kv_hop_bytes_wire=self._kv_wire,
            **kw)

    # ------------------------------------------------------------------
    def _run_boundary(self, requests: Sequence[ServeRequest]
                      ) -> Tuple[List[RequestOutput], ContinuousStats]:
        """Boundary-blocking admission: every boundary with free slots
        runs prefill while the live slots wait (the A/B baseline; and the
        per-step loop when ``macro_steps=0``)."""
        K = self.macro_steps
        pending = deque(requests)
        slot_states: List[_Slot] = [_Slot() for _ in range(self.slots)]
        cache, cur_tok, lengths, remaining, done = self._init_state()
        outputs: List[RequestOutput] = []
        step_no = 0
        busy_acc = 0.0
        t_prefill = t_decode = 0.0
        t_slot_write = t_dispatch = t_await = 0.0
        host_syncs = dispatches = wave_launches = stalls = 0

        def _finished(s: _Slot) -> bool:
            return s.busy and (s.remaining <= 0
                               or (self.eos_id is not None
                                   and s.tokens[-1] == self.eos_id))

        while pending or any(s.busy for s in slot_states):
            # --- admit into every free slot ---------------------------
            with tracing.timed("engine.boundary") as sp:
                live_before = any(s.busy for s in slot_states)
                cache, cur_tok, lengths, remaining, done, n_sync, tw = \
                    self._admit_free_slots(pending, slot_states, cache,
                                           cur_tok, lengths, remaining, done,
                                           step_no)
            t_slot_write += tw
            host_syncs += n_sync
            if n_sync and live_before:
                stalls += 1     # live slots sat idle through this prefill
            t_prefill += sp.seconds

            # --- evict completed slots ---------------------------------
            freed = False
            for i, s in enumerate(slot_states):
                if _finished(s):
                    outputs.append(RequestOutput(
                        uid=s.uid, tokens=np.asarray(s.tokens, np.int32),
                        admitted_step=s.admitted_step,
                        finished_step=s.finished_at if s.finished_at >= 0
                        else step_no))
                    slot_states[i] = _Slot()
                    done[i] = True       # freeze the freed slot
                    freed = True
            if freed and pending:
                continue  # refill freed slots before the next decode step
            if not any(s.busy for s in slot_states):
                break

            if K == 0:
                # --- per-token loop: one step, one sync per token ------
                with tracing.timed("engine.per_step") as sp:
                    cache, cur_tok, lengths, new_tok = self._per_step_advance(
                        cache, cur_tok, lengths, done)
                host_syncs += 1
                t_decode += sp.seconds
                step_no += 1
                busy_acc += sum(1 for s in slot_states if s.busy) / self.slots
                for i, s in enumerate(slot_states):
                    if s.busy:
                        s.tokens.append(int(new_tok[i]))
                        self._emit_tokens(s.uid, len(s.tokens) - 1,
                                          [s.tokens[-1]])
                        s.remaining -= 1
                continue

            # --- one fused macro-step (or wave of W) over all slots ----
            W = self.wave_steps
            fn = self._fused()
            with tracing.timed("engine.dispatch") as sp_d:
                toks, cache, cur_tok, lengths, remaining, done = _macro_step(
                    fn, (self.params, cache, cur_tok, lengths, remaining,
                         done, self._shard))
            with tracing.timed("engine.await") as sp_a:
                block = _fetch(toks).reshape(-1, self.slots)   # the one sync
            t_dispatch += sp_d.seconds
            t_await += sp_a.seconds
            host_syncs += 1
            dispatches += W
            wave_launches += 1
            with tracing.span("engine.consume"):
                steps_used, busy_inc = self._consume_block(
                    block, slot_states, W * K, step_no)
            busy_acc += busy_inc
            step_no += steps_used

        synchronize(self.device)
        if dispatches:
            # decode_s == t_dispatch_s + t_await_s exactly on the fused path
            t_decode = t_dispatch + t_await
        outputs.sort(key=lambda o: o.uid)
        return outputs, self._stats(
            outputs, step_no, busy_acc, t_prefill, t_decode,
            t_prefill + t_decode, host_syncs=host_syncs,
            macro_dispatches=dispatches, wave_launches=wave_launches,
            admission_stalls=stalls, t_slot_write_s=t_slot_write,
            t_dispatch_s=t_dispatch, t_await_s=t_await)

    # ------------------------------------------------------------------
    def _run_overlapped(self, requests: Sequence[ServeRequest]
                        ) -> Tuple[List[RequestOutput], ContinuousStats]:
        """Speculative overlapped admission (the fused-path default).

        Each iteration: (1) splice the ready shadow prefills into the free
        slots with one :func:`admit_boundary` over slot-width padded
        vectors (a shadow miss with live slots waiting is an admission
        stall); (2) launch the macro-step (or wave) for the live slots, on
        the launcher thread with ``async_dispatch``; (3) top the shadow
        queue back up to ``slots`` speculative B=1 prefills, which run
        behind the in-flight macro-step; (4) read its token block (the one
        host sync), with the spliced slots' first tokens, and evict
        finished slots.

        On the card the shadow work (prefix-cache lookups, prefills, the
        prefill group's dispatch and fetch) goes on a side stream; each
        shadow records an event there, the decode stream waits on it before
        the splice reads the shadow's tensors, and those tensors are
        recorded on the decode stream so the allocator cannot hand their
        memory out while the splice is still queued.

        With a ``prefill_worker`` the shadows are prefilled on the prefill
        group and their blocks fetched back over its priced hop (only a
        resumed prefill's compacted tail crosses); a worker failure at
        dispatch or fetch falls back to local prefill for that request and
        every later one, counted in ``prefill_fallbacks``."""
        from repro_torch.core.offload import GroupUnavailableError
        from repro_torch.serving.prefill import PrefillWorkerError

        worker_errors = (PrefillWorkerError, GroupUnavailableError)
        dev = self.device
        K, W, eos = self.macro_steps, self.wave_steps, self.eos_id
        worker = self.prefill_worker
        pending = deque(requests)
        shadows: deque = deque()          # in-flight speculative prefills
        slot_states: List[_Slot] = [_Slot() for _ in range(self.slots)]
        cache, cur_tok, lengths, remaining, done = self._init_state()
        decode_stream, side = None, self._side
        if side is not None:
            decode_stream = torch.cuda.current_stream(dev)
            side.wait_stream(decode_stream)   # params, state, earlier runs
        outputs: List[RequestOutput] = []
        step_no = 0
        busy_acc = 0.0
        t_prefill = t_overlap = t_kv_transfer = 0.0
        t_splice = t_slot_write = t_dispatch = t_await = 0.0
        host_syncs = dispatches = stalls = n_shadow = wave_launches = 0
        n_offloaded = n_fallbacks = 0

        def _ready():
            """An event after the side stream's work so far (None on CPU)."""
            if side is None:
                return None
            ev = torch.cuda.Event()
            ev.record(side)
            return ev

        def _consume(sh: _Shadow) -> None:
            """Order the decode stream after the shadow's work and keep its
            tensors' memory until the decode stream is done with them."""
            if sh.ready is None:
                return
            decode_stream.wait_event(sh.ready)
            for t in tree_leaves((sh.logits, sh.cache)):
                if torch.is_tensor(t):
                    t.record_stream(decode_stream)

        def _use_remote() -> bool:
            return (worker is not None and self.prefill_remote
                    and worker.healthy)

        def _dispatch_shadow(exposed: bool):
            req = pending.popleft()
            with torch.cuda.stream(side), tracing.span(
                    "engine.prefill", req.uid, exposed=exposed):
                sh = _shadow_prefill(req)
                sh.ready = _ready()
            shadows.append(sh)

        def _shadow_prefill(req: ServeRequest) -> _Shadow:
            nonlocal n_offloaded, n_fallbacks
            pc = self.prefix_cache
            hit = None
            if pc is not None:
                hit = pc.match(req.prompt, frontend=req.frontend)
                self._account_hit(hit)
                if hit.full is not None:
                    # exact full hit: no prefill anywhere and no KV hop
                    logits, cache_ = hit.full
                    return _Shadow(req, logits,
                                   None if req.max_new <= 1 else cache_)
            batch = self._make_batch(req)
            if hit is not None and hit.prefix is not None:
                batch = dict(batch, prefix=hit.prefix)
            # a single-token request never takes a slot: park its logits only
            if _use_remote():
                try:
                    last_logits, pre_cache = worker.dispatch(batch)
                    n_offloaded += 1
                    return _Shadow(req, last_logits,
                                   None if req.max_new <= 1 else pre_cache,
                                   remote=True, hit=hit)
                except worker_errors:
                    n_fallbacks += 1    # this and every later shadow local
            last_logits, pre_cache = self._prefill(batch)
            if pc is not None:
                pc.insert(req.prompt, last_logits, pre_cache,
                          frontend=req.frontend)
                pc.release(hit)
            return _Shadow(req, last_logits,
                           None if req.max_new <= 1 else pre_cache)

        def _localize(sh: _Shadow) -> Tuple[_Shadow, int]:
            """Bring a remote shadow's block over the priced hop (a resumed
            prefill ships only its compacted tail); a local shadow passes
            through.  A fetch failure re-prefills locally, which is exposed
            prefill: the caller counts it like a shadow miss."""
            nonlocal t_kv_transfer, n_fallbacks
            if not sh.remote:
                return sh, 0
            pc = self.prefix_cache
            prefix = sh.hit.prefix if sh.hit is not None else None
            with torch.cuda.stream(side):
                try:
                    logits, blk, t_hop = worker.fetch(
                        sh.logits, sh.cache, target=dev, prefix=prefix)
                    t_kv_transfer += t_hop
                    raw, wire = worker.last_fetch_bytes
                    self._kv_raw += raw
                    self._kv_wire += wire
                    if pc is not None:
                        if blk is not None:
                            pc.insert(sh.req.prompt, logits, blk,
                                      frontend=sh.req.frontend)
                        pc.release(sh.hit)
                    return _Shadow(sh.req, logits, blk, ready=_ready()), 0
                except worker_errors:
                    n_fallbacks += 1
                    batch = self._make_batch(sh.req)
                    if prefix is not None:
                        batch = dict(batch, prefix=prefix)
                    with tracing.span("engine.prefill", sh.req.uid,
                                      exposed=True):
                        logits, pre = self._prefill(batch)
                    if pc is not None:
                        pc.insert(sh.req.prompt, logits, pre,
                                  frontend=sh.req.frontend)
                        pc.release(sh.hit)
                    return _Shadow(sh.req, logits,
                                   None if sh.req.max_new <= 1 else pre,
                                   ready=_ready()), 1

        def _eos_done(s: _Slot) -> bool:
            return bool(s.tokens) and eos is not None and s.tokens[-1] == eos

        while pending or shadows or any(s.busy for s in slot_states):
            # --- 1. splice shadows into free slots (macro boundary) -----
            with tracing.timed("engine.boundary") as sp_b:
                boundary_step = step_no
                live_before = any(s.busy for s in slot_states)
                inline = 0
                newly: List[Tuple[int, ServeRequest, Any]] = []
                blocks: List[Any] = []
                # singles need no slot: flush every parked one at each
                # boundary
                singles: List[_Shadow] = [sh for sh in shadows
                                          if sh.req.max_new <= 1]
                if singles:
                    fillers = [sh for sh in shadows if sh.req.max_new > 1]
                    shadows.clear()
                    shadows.extend(fillers)
                free = (i for i, s in enumerate(slot_states) if not s.busy)
                slot = next(free, None)
                while slot is not None:
                    if not shadows:
                        if not pending:
                            break
                        _dispatch_shadow(True)   # shadow miss: prefill exposed
                        inline += 1
                    sh = shadows.popleft()
                    if sh.req.max_new <= 1:
                        singles.append(sh)   # completes from its prefill logits
                        continue
                    sh, exposed = _localize(sh)
                    inline += exposed
                    _consume(sh)
                    newly.append((slot, sh.req, sh.logits))
                    blocks.append(sh.cache)
                    slot = next(free, None)
                if singles:
                    flushed = []
                    for sh in singles:
                        sh, exposed = _localize(sh)   # logits-only transfer
                        inline += exposed
                        _consume(sh)
                        flushed.append(sh)
                    singles = flushed
                if inline and live_before:
                    stalls += 1   # decode waited on an un-overlapped prefill
                single_dev = None
                if singles:
                    single_dev = torch.cat(
                        [sh.logits for sh in singles],
                        dim=0).argmax(dim=-1).to(torch.int32)
                first_dev = None
                if newly:
                    # one boundary pass for every admitted block, over
                    # vectors and blocks padded to the slot width; its wall
                    # lands in the splice bucket (disaggregated) or the
                    # slot-write one
                    with tracing.timed("engine.splice") as sp_s:
                        ids, logits_cat, plens, mnews = \
                            self._pad_admit_args(newly)
                        blks = blocks + [blocks[-1]] * (self.slots
                                                        - len(blocks))
                        cache, cur_tok, lengths, remaining, done, first_dev = \
                            admit_boundary(
                                self.cfg, cache, blks, ids, cur_tok, lengths,
                                remaining, done, logits_cat, plens, mnews,
                                eos_id=-1 if eos is None else int(eos),
                                shard=self._shard)
                    if worker is not None:
                        t_splice += sp_s.seconds
                    else:
                        t_slot_write += sp_s.seconds
                    for slot, req, _ in newly:
                        slot_states[slot] = _Slot(
                            uid=req.uid, remaining=req.max_new - 1,
                            tokens=[], admitted_step=step_no)
            t_prefill += sp_b.seconds

            # --- 2. launch the macro-step (never waits on prefill) -----
            # the carried cache and state are handed to the launch and are
            # not touched until the rebind at step 4
            launch = None
            with tracing.timed("engine.dispatch") as sp_d:
                if any(s.busy and s.remaining > 0 and not _eos_done(s)
                       for s in slot_states):
                    fn = self._fused()
                    args = (self.params, cache, cur_tok, lengths, remaining,
                            done, self._shard)
                    launch = self._launcher.submit(fn, *args) \
                        if self._launcher is not None \
                        else _macro_step(fn, args)
            t_dispatch += sp_d.seconds

            # --- 3. top up speculative shadow prefills -----------------
            # depth counts only slot-filling shadows (singles never take a
            # slot and are flushed every boundary)
            with tracing.timed("engine.topup") as sp_t:
                while pending and sum(1 for sh in shadows
                                      if sh.req.max_new > 1) < self.slots:
                    _dispatch_shadow(False)
                    n_shadow += 1
            t_overlap += sp_t.seconds

            # --- 4. the one await: token block + the first tokens -------
            block = None
            with tracing.timed("engine.await") as sp_a:
                if launch is not None:
                    res = launch.result() if hasattr(launch, "result") \
                        else launch
                    toks, cache, cur_tok, lengths, remaining, done = res
                    block = _fetch(toks).reshape(-1, self.slots)
                    host_syncs += 1
                    dispatches += W
                    wave_launches += 1
                if first_dev is not None:
                    firsts = _fetch(first_dev)     # queued before the launch
                    host_syncs += 1
                    for (slot, req, _), first in zip(newly, firsts):
                        slot_states[slot].tokens.append(int(first))
                        self._emit_tokens(req.uid, 0, [int(first)])
                if single_dev is not None:
                    host_syncs += 1
                    for sh, first in zip(singles, _fetch(single_dev)):
                        outputs.append(RequestOutput(
                            uid=sh.req.uid,
                            tokens=np.asarray([int(first)], np.int32),
                            admitted_step=boundary_step,
                            finished_step=boundary_step))
                        self._emit_tokens(sh.req.uid, 0, [int(first)])
            t_await += sp_a.seconds

            if block is not None:
                with tracing.span("engine.consume"):
                    steps_used, busy_inc = self._consume_block(
                        block, slot_states, W * K, step_no)
                busy_acc += busy_inc
                step_no += steps_used

            # --- evict finished slots (they resplice at step 1) --------
            for i, s in enumerate(slot_states):
                if s.busy and (s.remaining <= 0 or _eos_done(s)):
                    outputs.append(RequestOutput(
                        uid=s.uid, tokens=np.asarray(s.tokens, np.int32),
                        admitted_step=s.admitted_step,
                        finished_step=s.finished_at if s.finished_at >= 0
                        else step_no))
                    slot_states[i] = _Slot()

        synchronize(dev)
        # decode_s is dispatch + await (step 3's overlap window excluded)
        t_decode = t_dispatch + t_await
        outputs.sort(key=lambda o: o.uid)
        return outputs, self._stats(
            outputs, step_no, busy_acc, t_prefill, t_decode,
            t_prefill + t_decode + t_overlap, host_syncs=host_syncs,
            macro_dispatches=dispatches, wave_launches=wave_launches,
            t_prefill_overlap_s=t_overlap, admission_stalls=stalls,
            shadow_prefills=n_shadow, prefill_offloaded=n_offloaded,
            t_kv_transfer_s=t_kv_transfer, prefill_fallbacks=n_fallbacks,
            t_splice_s=t_splice, t_slot_write_s=t_slot_write,
            t_dispatch_s=t_dispatch, t_await_s=t_await)
