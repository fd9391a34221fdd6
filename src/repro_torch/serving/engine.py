"""Serving engine: prefill + decode steps, batched greedy generation.

The static part of the JAX package's ``repro/serving/engine.py``.
``make_decode_loop`` is the fused hot path: K decode steps per dispatch with
greedy sampling, per-slot lengths and eos detection all on the device; the
host fetches one ``[K, B]`` token block per macro-step.  The loop runs
eagerly: where JAX donates the cache and the decode-state vectors, the port
updates those tensors in place.  The per-slot ``lengths`` are the decode
``cache_index``, so on the fused path the decode-attention kernel is always
fed per-slot lengths.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.offload import tree_map
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.kernels.ops import resolve_use_kernels
from repro_torch.models import model as M


def _use(use_kernels: Union[bool, str], t: torch.Tensor) -> bool:
    return resolve_use_kernels(use_kernels, t.device)


def make_prefill_step(cfg, *, use_kernels: Union[bool, str] = "auto"):
    """(params, batch) -> (last_logits [B,V], caches)."""
    def prefill_step(params, batch):
        out = M.forward(params, cfg, batch, mode="prefill",
                        use_kernels=_use(use_kernels, batch["tokens"]))
        return out.logits[:, -1], out.cache
    return prefill_step


def make_serve_step(cfg, *, use_kernels: Union[bool, str] = "auto"):
    """(params, cache, token [B,1], cache_index) -> (logits [B,V], cache);
    the cache is updated in place."""
    def serve_step(params, cache, token, cache_index):
        out = M.forward(params, cfg,
                        {"token": token, "cache": cache,
                         "cache_index": cache_index},
                        mode="decode", use_kernels=_use(use_kernels, token))
        return out.logits[:, 0], out.cache
    return serve_step


def make_decode_loop(cfg, *, macro_steps: int, eos_id: Optional[int] = None,
                     use_kernels: Union[bool, str] = "auto"):
    """Fused K-token decode.

    ``(params, cache, cur_tok [B], lengths [B], remaining [B], done [B])
    -> (tokens [K, B], cache, cur_tok, lengths, remaining, done)``

    Each step runs one decode step for every slot, takes the greedy argmax
    on the device (first index on ties), and advances only the live slots:
    a slot freezes the step it emits its ``remaining``-th token or
    ``eos_id``.  Frozen slots keep executing with junk inputs; the per-slot
    length masks isolate their cache rows.  The cache and the four state
    vectors are updated in place (the JAX loop donates them) and returned.
    """
    eos = -1 if eos_id is None else int(eos_id)

    def decode_loop(params, cache, cur_tok, lengths, remaining, done):
        kern = _use(use_kernels, cur_tok)
        toks = torch.empty((macro_steps, cur_tok.shape[0]), dtype=torch.int32,
                           device=cur_tok.device)
        for i in range(macro_steps):
            out = M.forward(params, cfg,
                            {"token": cur_tok[:, None], "cache": cache,
                             "cache_index": lengths},
                            mode="decode", use_kernels=kern)
            new_tok = out.logits[:, 0].argmax(dim=-1).to(torch.int32)
            active = ~done
            step = active.to(torch.int32)
            cur_tok.copy_(torch.where(active, new_tok, cur_tok))
            lengths += step
            remaining -= step
            done |= active & ((remaining <= 0) | (cur_tok == eos))
            toks[i] = cur_tok
        return toks, cache, cur_tok, lengths, remaining, done

    return decode_loop


# ---------------------------------------------------------------------------
def seed_cache(cfg, big_cache, prefill_cache, prefill_len: int):
    """Copy the prefill caches into the full-size decode buffers, in place,
    leaf by leaf over every cache family (dicts of K/V, tuples of SSM
    states): each prefill leaf is written at offset 0 of axis 2.  For the
    length-P K/V buffers that is the first P positions; for same-shape
    leaves (the conv and SSM states) it replaces the whole leaf."""
    tree_map(lambda dst, src: dst[:, :, :src.shape[2]].copy_(src),
             big_cache, prefill_cache)
    return big_cache


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
        self.decode_steps = 0

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new: int = 16,
                 frontend: Optional[np.ndarray] = None) -> GenerationResult:
        """prompts: [B, P] int32 (pre-padded)."""
        if frontend is not None:
            raise NotImplementedError("frontend (vlm/audio) inputs are not "
                                      "ported yet")
        cfg, dev = self.cfg, self.device
        B, P = prompts.shape
        tokens = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
        t0 = time.perf_counter()
        last_logits, pre_cache = self.prefill(self.params, {"tokens": tokens})
        synchronize(dev)
        t_prefill = time.perf_counter() - t0

        cache = M.init_cache(cfg, B, self.max_len, dtype=cfg.torch_dtype,
                             device=dev)
        cache = seed_cache(cfg, cache, pre_cache, P)
        del pre_cache

        if self.macro_steps == 0:
            return self._generate_per_step(last_logits, cache, P, max_new,
                                           t_prefill)

        K = self.macro_steps
        loop = make_decode_loop(cfg, macro_steps=K, use_kernels=self._use_kernels)
        tok = last_logits.argmax(dim=-1).to(torch.int32)
        lengths = torch.full((B,), P, dtype=torch.int32, device=dev)
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
                self.params, cache, tok, lengths, remaining, done)
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
                           t_prefill: float) -> GenerationResult:
        """Per-token host loop: one dispatch + one host sync per token."""
        tok = last_logits.argmax(dim=-1)[:, None].to(torch.int32)
        out_toks = [tok.cpu().numpy()]
        host_syncs = 1
        # device-resident position counter: one upload, then it advances
        # on the device
        idx_dev = torch.tensor(idx, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            logits, cache = self.step(self.params, cache, tok, idx_dev)
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
