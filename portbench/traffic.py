"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes every request from the run's seed.

A mix fixes the work and the seed only orders it.  Every batch holds the
same output lengths, the ``batch`` quantiles of the mix's log-normal
(clipped), in an order drawn from the seed, so two seeds give the same
amount of work; the prompts are drawn from the seed over the model's
vocabulary, and no two prompts of a run share a first token, so no two
share a prefix.
"""
from __future__ import annotations

import json
import math
import statistics
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class Request:
    uid: int
    prompt: np.ndarray          # [prompt_len] int32
    max_new: int


def load_mix(root: Path, name: str) -> Dict:
    """``traffic/<name>.json`` under the benchmark's folder ``root``."""
    return json.loads((Path(root) / "traffic" / f"{name}.json").read_text())


def batch_size(mix: Dict) -> int:
    """Requests a batch holds: the runtime's wave, ``waves_of_slots`` x
    the slots of a group (2 x slots on a pair)."""
    return int(mix["waves_of_slots"]) * int(mix["slots"])


def output_lengths(mix: Dict) -> List[int]:
    """The batch's output lengths: the log-normal's quantiles at
    (i + 0.5) / n, rounded and clipped to [min, max]."""
    spec = mix["output_len"]
    n = batch_size(mix)
    dist = statistics.NormalDist()
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    return [int(min(max(round(math.exp(mu + sigma * dist.inv_cdf(
        (i + 0.5) / n))), spec["min"]), spec["max"])) for i in range(n)]


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of the run's seed (any whole number
    up to 2**63, negative ones too)."""
    return np.random.default_rng([int(seed) % 2**63, *stream])


class Generator:
    """Batches of :class:`Request` for one run: ``batch(b)`` is the b-th
    batch the closed loop submits; ``warm()`` the set-up's request, drawn
    from a stream of its own."""

    STREAM_BATCH, STREAM_FIRST, STREAM_WARM = 1, 2, 3

    def __init__(self, mix: Dict, vocab_size: int, seed: int):
        self.mix, self.vocab, self.seed = mix, int(vocab_size), int(seed)
        self.lengths = output_lengths(mix)
        self.P = int(mix["prompt_len"])
        # distinct first tokens for every request of the run
        self._firsts = _rng(seed, self.STREAM_FIRST).permutation(self.vocab)

    def batch(self, b: int) -> List[Request]:
        n = len(self.lengths)
        rng = _rng(self.seed, self.STREAM_BATCH, b)
        order = rng.permutation(n)
        prompts = rng.integers(0, self.vocab, size=(n, self.P), dtype=np.int64)
        first = self._firsts[(b * n + np.arange(n)) % self.vocab]
        prompts[:, 0] = first
        return [Request(uid=b * n + i, prompt=prompts[i].astype(np.int32),
                        max_new=self.lengths[order[i]]) for i in range(n)]

    def warm(self) -> Request:
        rng = _rng(self.seed, self.STREAM_WARM)
        prompt = rng.integers(0, self.vocab, size=(self.P,), dtype=np.int64)
        return Request(uid=2**30, prompt=prompt.astype(np.int32),
                       max_new=int(self.mix["warm_max_new"]))
