"""Data pipeline: the synthetic training corpus and the serving request
generator (numpy only).

Training data is a deterministic synthetic LM stream (Zipf-ish unigrams with
a short-range bigram structure, learnable without an external dataset).
Serving data is a Poisson request generator with log-normal prompt lengths
-- the "image batch" analogue that HeteroEdge splits across nodes.  Both
draw the same arrays from the same seed as the JAX package's
``synthetic_lm_batches`` and ``request_stream``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    frontend_tokens: int = 0
    frontend_dim: int = 0


def synthetic_lm_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {"tokens": [B,S] int32} (+"frontend" [B,F,fd]
    f32) batches.

    Token stream: Zipf unigrams with a deterministic bigram successor table --
    a model that learns p(next|prev) drops loss well below unigram entropy.
    """
    rng = np.random.default_rng(cfg.seed)
    V = cfg.vocab_size
    probs = 1.0 / np.arange(1, V + 1) ** 1.1
    probs /= probs.sum()
    successor = rng.permutation(V)  # deterministic bigram: w -> successor[w]
    while True:
        first = rng.choice(V, size=(cfg.batch_size, 1), p=probs)
        toks = [first]
        cur = first
        # 70% bigram-follow / 30% resample: learnable but not trivial
        for _ in range(cfg.seq_len - 1):
            follow = successor[cur]
            resample = rng.choice(V, size=cur.shape, p=probs)
            take = rng.random(cur.shape) < 0.7
            cur = np.where(take, follow, resample)
            toks.append(cur)
        batch = {"tokens": np.concatenate(toks, axis=1).astype(np.int32)}
        if cfg.frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (cfg.batch_size, cfg.frontend_tokens,
                 cfg.frontend_dim)).astype(np.float32)
        yield batch


@dataclass
class Request:
    uid: int
    arrival_s: float
    prompt: np.ndarray            # [prompt_len] int32
    max_new_tokens: int
    frontend: Optional[np.ndarray] = None


def request_stream(vocab: int, *, rate_hz: float = 20.0, mean_prompt: int = 128,
                   max_new: int = 32, n: int = 100, seed: int = 0,
                   frontend_tokens: int = 0, frontend_dim: int = 0
                   ) -> List[Request]:
    """Poisson arrivals with log-normal prompt lengths (serving workload)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n):
        t += rng.exponential(1.0 / rate_hz)
        plen = int(np.clip(rng.lognormal(np.log(mean_prompt), 0.5), 8, 4 * mean_prompt))
        fe = None
        if frontend_tokens:
            fe = rng.standard_normal((frontend_tokens, frontend_dim)).astype(np.float32)
        reqs.append(Request(uid=i, arrival_s=t,
                            prompt=rng.integers(0, vocab, plen).astype(np.int32),
                            max_new_tokens=max_new, frontend=fe))
    return reqs
