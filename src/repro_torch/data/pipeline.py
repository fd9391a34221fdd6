"""Serving request generator (numpy only).

Poisson arrivals with log-normal prompt lengths -- the "image batch"
analogue that HeteroEdge splits across nodes.  Draws the same prompts from
the same seed as the JAX package's ``request_stream``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


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
