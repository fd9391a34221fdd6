"""Wrapper of the hand-written CUDA masked-compaction kernel.

The kernel (``csrc/masked_compact.cu``) replaces the Pallas TPU kernel
``repro/kernels/masked_compact.py:masked_compact_pallas``: order-preserving
compaction of the masked rows of ``tokens`` into a ``[B, K, D]`` buffer.
Its plain version is :func:`repro_torch.kernels.ref.masked_compact_ref`.

Its grid runs over (batch row, tile of source rows, chunk of the row's
bytes); :func:`masked_compact_plan` picks the tile and the chunk count on
the host from the shapes alone, so nothing is read back from the device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

SMS = 132                 # H100 SXM streaming multiprocessors
THREADS = 256             # threads a block: one per row of the largest tile
MIN_TILE = 32             # one warp of rows
MIN_CHUNK_BYTES = 512     # a chunk keeps a warp's 16-byte lanes on one row
BLOCKS_PER_SM = 4         # the grid the plan aims for: 528 blocks
MIN_BLOCK_BYTES = 4096    # ... unless blocks would move less than this each
MAX_RECOUNT = 1 << 26     # S * S * chunks / tile above which the count pass
                          # pays: the blocks of a row recount half that many
                          # mask bytes from L2 (measured crossover, PERF.md)
_INT_MAX = 2 ** 31 - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class MaskedCompactPlan:
    """Launch shape: ``blocks = B * n_tiles * chunks``.  Block ``(b, t, c)``
    scans source rows ``[t*tile, t*tile + tile)`` of row ``b`` (clipped to
    S), writes the t-th of ``n_tiles`` equal shares of the empty slots
    ``[count, K)``, and moves chunk ``c`` of each of those rows' bytes
    (``ceil(vectors / chunks)`` vectors a chunk).  ``long_rows`` adds a
    count pass into a ``[B, n_tiles]`` int32 workspace."""
    tile: int
    n_tiles: int
    chunks: int
    long_rows: bool
    blocks: int


def make_plan(B: int, S: int, K: int, tile: int, chunks: int,
              long_rows: bool) -> MaskedCompactPlan:
    """The plan with this tile and chunk count; tiles cover max(S, K, 1)
    rows, so with K > S the tiles past S write only empty slots."""
    n_tiles = _cdiv(max(S, K, 1), tile)
    return MaskedCompactPlan(tile, n_tiles, chunks, bool(long_rows),
                             B * n_tiles * chunks)


@functools.lru_cache(maxsize=256)
def masked_compact_plan(B: int, S: int, row_bytes: int, K: int, *,
                        long_rows=None) -> MaskedCompactPlan:
    """Tile and chunk count for ``tokens [B,S,row_bytes]`` into ``K`` slots.

    Starts at the smallest power-of-two tile >= the rows (32-256) and one
    chunk, then halves the tile down to 32 rows, then splits the row's
    bytes in two (while a chunk keeps >= 512 bytes), until the grid holds
    ``BLOCKS_PER_SM`` blocks an SM or each block would move fewer than
    ``MIN_BLOCK_BYTES``.  ``long_rows`` defaults to true where the blocks
    of a row would recount more than ``MAX_RECOUNT / 2`` mask bytes in all
    (``n_tiles * chunks`` blocks, S / 2 bytes each on average): below that
    the recount costs less than the count pass's extra launch.
    """
    rows = max(S, K, 1)
    tile = min(THREADS, max(MIN_TILE, 1 << (rows - 1).bit_length()))
    chunks = 1
    moved = B * (min(S, K) + K) * row_bytes      # rows read at most + written
    want = min(BLOCKS_PER_SM * SMS, max(1, moved // MIN_BLOCK_BYTES))
    while B * _cdiv(rows, tile) * chunks < want:
        if tile > MIN_TILE:
            tile //= 2
        elif row_bytes // (2 * chunks) >= MIN_CHUNK_BYTES:
            chunks *= 2
        else:
            break
    if long_rows is None:
        long_rows = S * S * chunks > MAX_RECOUNT * tile
    return make_plan(B, S, K, tile, chunks, long_rows)


def masked_compact_cuda(tokens: torch.Tensor, mask: torch.Tensor,
                        capacity: int, *, plan: MaskedCompactPlan = None):
    """tokens: [B,S,D] (any dtype, contiguous, CUDA); mask: [B,S] bool on
    the same device.  Returns (out [B,K,D] tokens dtype, idx [B,K] int32,
    count [B] int32).  Launches on the current stream and counts the launch
    in ``masked_compact_cuda.launches``.  ``plan`` overrides
    :func:`masked_compact_plan` (for timing its branches)."""
    if tokens.dim() != 3 or mask.shape != tokens.shape[:2]:
        raise ValueError(f"masked_compact_cuda: bad shapes tokens "
                         f"{tuple(tokens.shape)}, mask {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"masked_compact_cuda: mask dtype {mask.dtype}, "
                        "expected torch.bool")
    K = int(capacity)
    if K < 0:
        raise ValueError(f"masked_compact_cuda: capacity {K} < 0")
    B, S, D = tokens.shape
    if B == 0:
        raise ValueError("masked_compact_cuda: empty batch")
    if not tokens.is_cuda or mask.device != tokens.device:
        raise ValueError(f"masked_compact_cuda: tokens on {tokens.device} and "
                         f"mask on {mask.device}; both must be on one CUDA "
                         "device")
    if not tokens.is_contiguous() or not mask.is_contiguous():
        raise ValueError("masked_compact_cuda: tokens and mask must be "
                         "contiguous")
    row_bytes = D * tokens.element_size()
    if plan is None:
        plan = masked_compact_plan(B, S, row_bytes, K)
    if (row_bytes * THREADS > _INT_MAX or max(S, K) + THREADS > _INT_MAX
            or plan.n_tiles * plan.chunks * B > _INT_MAX
            or not 1 <= plan.tile <= THREADS
            or plan.n_tiles * plan.tile < max(S, K, 1)):
        raise ValueError(f"masked_compact_cuda: tokens {tuple(tokens.shape)} "
                         f"x {tokens.element_size()} bytes, K {K} and {plan} "
                         "exceed the kernel's int32 indexing or do not "
                         "cover the rows")
    dev = tokens.device
    out = torch.empty((B, K, D), dtype=tokens.dtype, device=dev)
    idx = torch.empty((B, K), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    ws = (torch.empty((B * plan.n_tiles,), dtype=torch.int32, device=dev)
          if plan.long_rows else None)
    launch = _build.load().repro_masked_compact
    args = (tokens.data_ptr(), mask.data_ptr(), out.data_ptr(), idx.data_ptr(),
            count.data_ptr(), None if ws is None else ws.data_ptr(), B, S,
            row_bytes, K, plan.tile, plan.n_tiles, plan.chunks,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = launch(*args)
    else:                       # the launch goes to the current device
        with torch.cuda.device(dev):
            err = launch(*args)
    _build.check(err, "masked_compact")
    masked_compact_cuda.launches += 1
    return out, idx, count


masked_compact_cuda.launches = 0
