"""Frame-level compression via masking (paper §VI), on tokens.

Paper: a detector produces a binary mask; mask ⊙ image isolates objects of
interest, cutting offloaded bytes ~28% and downstream compute ~13% for a
~2% accuracy cost.  Here the unit shipped between node groups is a token
embedding: a cheap relevance scorer marks tokens of interest, and the
``masked_compact`` kernel packs them into the dense ``[B, K, D]`` buffer
that is what crosses the link.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import ops


@dataclass
class CompressionReport:
    kept_tokens: int
    total_tokens: int
    bytes_before: float
    bytes_after: float

    @property
    def bandwidth_saving(self) -> float:
        return 1.0 - self.bytes_after / max(self.bytes_before, 1e-9)

    @property
    def keep_rate(self) -> float:
        return self.kept_tokens / max(self.total_tokens, 1)


def norm_scores(tokens: torch.Tensor) -> torch.Tensor:
    """Token salience = embedding L2 norm (magnitude pruning), float32."""
    return torch.linalg.vector_norm(tokens.float(), dim=-1)


def make_mask(scores: torch.Tensor, keep_rate: float) -> torch.Tensor:
    """Binary mask keeping the top ``keep_rate`` fraction per sequence."""
    B, S = scores.shape
    k = max(1, int(round(keep_rate * S)))
    thresh = torch.sort(scores, dim=-1).values[:, S - k][:, None]
    return scores >= thresh


def compress_tokens(tokens: torch.Tensor, mask: torch.Tensor,
                    capacity: Optional[int] = None, use_kernels: bool = False):
    """Compact masked tokens into [B, K, D] (+ index map [B, K], count [B]).

    The compacted buffer + int32 indices are the offload payload.  K
    defaults to S; pass ``capacity`` to bound the buffer."""
    K = capacity or tokens.shape[1]
    return ops.masked_compact(tokens, mask, K, use_kernels=use_kernels)


def compression_report(mask: torch.Tensor, capacity: int, d_model: int,
                       bytes_per_el: int = 2,
                       index_bytes: int = 4) -> CompressionReport:
    B, S = mask.shape
    kept = int(torch.clamp(mask.sum(dim=1), max=capacity).sum())
    before = B * S * d_model * bytes_per_el
    after = (kept * d_model * bytes_per_el) + kept * index_bytes
    return CompressionReport(kept_tokens=kept, total_tokens=B * S,
                             bytes_before=before, bytes_after=after)
