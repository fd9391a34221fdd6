"""masked_compact's launch plan, and the port's compaction against JAX.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).  Here: the host plan fills the card at
the payload's shape, and its tiles, empty-slot ranges and byte chunks
cover every source row, slot and byte once, so a numpy walk of the plan
(the kernel's arithmetic, block by block) gives ``ref.masked_compact_ref``
bit for bit; the port's ``ops.masked_compact`` matches the JAX package where
the Pallas kernel cannot run (K > S, S = 1, S not a multiple of 128) and at
the KV hop's layout; the wrapper refuses what the kernel does not take.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import masking as jmasking  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import masking  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.masked_compact import (  # noqa: E402
    MAX_RECOUNT, THREADS, masked_compact_cuda, masked_compact_plan)

S_SWEEP = (1, 127, 128, 129, 1000, 5000, 32768)
K_SWEEP = {"K0": lambda S: 0, "K1": lambda S: 1,
           "K_lt_kept": lambda S: max(1, S // 2), "K_eq_S": lambda S: S,
           "K_gt_S": lambda S: S + 37}
ROW_BYTES = (5, 10, 1024, 8192)


def _mask(rng, B, S):
    """72% kept, as the launcher's payload keeps."""
    return rng.random((B, S)) < 0.72


def _vector_bytes(row_bytes):
    """The widest copy vector the kernel takes for aligned buffers."""
    return next(v for v in (16, 4, 2, 1) if row_bytes % v == 0)


# the kernel's arithmetic (csrc/masked_compact.cu), block by block
def _tile_rows(plan, t, S):
    lo = min(t * plan.tile, S)
    return lo, min(lo + plan.tile, S)


def _zero_slots(plan, t, count, K):
    z = K - count
    return count + z * t // plan.n_tiles, count + z * (t + 1) // plan.n_tiles


def _chunk_vectors(plan, c, n_vectors):
    per = -(-n_vectors // plan.chunks)
    v0 = min(c * per, n_vectors)
    return v0, min(v0 + per, n_vectors)


def _walk(plan, mask, K, n_vectors, tokens=None, vec=1):
    """The kernel's work, block by block: block (b, t, c) takes the base of
    tile t (from the mask before it, or from the per-tile counts of the
    count pass on long rows), copies chunk c of its kept rows to their
    slots and writes its share of the empty slots.  Returns the number of
    writes of every (b, slot, vector) and, given ``tokens`` (uint8
    [B,S,row_bytes]), the kernel's (out, idx, count)."""
    B, S = mask.shape
    writes = np.zeros((B, K, n_vectors), np.int32)
    if tokens is not None:
        out = np.full((B, K, tokens.shape[2]), 0xAB, np.uint8)   # poisoned
        idx = np.full((B, K), -7, np.int32)
        count = np.full((B,), -7, np.int32)
    for b in range(B):
        m = mask[b]
        ws = [int(m[slice(*_tile_rows(plan, t, S))].sum()) for t in range(plan.n_tiles)]
        for t in range(plan.n_tiles):
            lo, hi = _tile_rows(plan, t, S)
            base = sum(ws[:t]) if plan.long_rows else int(m[:lo].sum())
            total = sum(ws) if plan.long_rows else int(m.sum())
            src = lo + np.flatnonzero(m[lo:hi])
            cnt = min(total, K)
            n_copy = max(0, min(len(src), K - base))
            z0, z1 = _zero_slots(plan, t, cnt, K)
            for c in range(plan.chunks):
                v0, v1 = _chunk_vectors(plan, c, n_vectors)
                writes[b, base:base + n_copy, v0:v1] += 1
                writes[b, z0:z1, v0:v1] += 1
                if tokens is None:
                    continue
                cols = slice(v0 * vec, v1 * vec)
                out[b, base:base + n_copy, cols] = tokens[b, src[:n_copy], cols]
                out[b, z0:z1, cols] = 0
                if c == 0:
                    idx[b, base:base + n_copy] = src[:n_copy]
                    idx[b, z0:z1] = -1
                    if t == 0:
                        count[b] = cnt
    return writes if tokens is None else (writes, out, idx, count)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [2048, 4096], ids=["d2048", "d4096"])
def test_plan_fills_the_card_at_the_payload(D):
    """The §VI payload [11,128,D] bf16, K=128: at least 2 blocks an SM."""
    plan = masked_compact_plan(11, 128, 2 * D, 128)
    assert plan.blocks >= 2 * 132
    assert plan.blocks == 11 * plan.n_tiles * plan.chunks
    assert not plan.long_rows
    assert 1 <= plan.tile <= THREADS and plan.n_tiles * plan.tile >= 128


@pytest.mark.parametrize("row_bytes", ROW_BYTES)
@pytest.mark.parametrize("kname", list(K_SWEEP))
@pytest.mark.parametrize("S", S_SWEEP)
def test_plan_covers_every_row_slot_and_byte_once(S, kname, row_bytes, test_seed):
    """Every source row lies in exactly one tile; every (slot, vector) is
    written exactly once, by a copy or as an empty slot, for the plan's
    base-finding branch and the other; the chunks cut every vector width
    the kernel may take into disjoint ranges that cover the row."""
    rng = np.random.default_rng(test_seed)
    K = K_SWEEP[kname](S)
    mask = _mask(rng, 2, S)
    plan = masked_compact_plan(2, S, row_bytes, K)
    assert plan.long_rows == (S * S * plan.chunks > MAX_RECOUNT * plan.tile)
    assert plan.blocks == 2 * plan.n_tiles * plan.chunks
    rows = np.zeros(S, np.int32)
    for t in range(plan.n_tiles):
        lo, hi = _tile_rows(plan, t, S)
        assert 0 <= hi - lo <= plan.tile
        rows[lo:hi] += 1
    assert (rows == 1).all()
    for vec in {_vector_bytes(row_bytes), 2 if row_bytes % 2 == 0 else 1, 1}:
        n_vectors = row_bytes // vec
        got = np.zeros(n_vectors, np.int32)
        for c in range(plan.chunks):
            got[slice(*_chunk_vectors(plan, c, n_vectors))] += 1
        assert (got == 1).all()
    n_vectors = min(plan.chunks, row_bytes)      # one vector per chunk suffices
    for long_rows in (plan.long_rows, not plan.long_rows):
        p = masked_compact_plan(2, S, row_bytes, K, long_rows=long_rows)
        assert (p.tile, p.n_tiles, p.chunks) == (plan.tile, plan.n_tiles, plan.chunks)
        assert (_walk(p, mask, K, n_vectors) == 1).all()


@pytest.mark.parametrize("kname", list(K_SWEEP))
@pytest.mark.parametrize("S", S_SWEEP[:6])
def test_plan_walk_matches_ref(S, kname, test_seed):
    """A numpy walk of the plan, bytes and all, reproduces
    ref.masked_compact_ref bit for bit at every row width that fits 16 MB,
    both base-finding branches; no byte of out is left unwritten."""
    rng = np.random.default_rng(test_seed)
    K = K_SWEEP[kname](S)
    for row_bytes in ROW_BYTES:
        B = 2
        if B * S * row_bytes > 16 << 20:
            continue
        tokens = rng.integers(0, 256, (B, S, row_bytes), dtype=np.uint8)
        mask = _mask(rng, B, S)
        want = ref.masked_compact_ref(torch.from_numpy(tokens),
                                      torch.from_numpy(mask), K)
        vec = _vector_bytes(row_bytes)
        for long_rows in (False, True):
            plan = masked_compact_plan(B, S, row_bytes, K, long_rows=long_rows)
            writes, out, idx, count = _walk(plan, mask, K, row_bytes // vec,
                                            tokens, vec)
            assert (writes == 1).all()
            np.testing.assert_array_equal(out, want[0].numpy())
            np.testing.assert_array_equal(idx, want[1].numpy())
            np.testing.assert_array_equal(count, want[2].numpy())


def test_plan_reads_nothing_from_the_device(monkeypatch):
    """The plan is arithmetic on Python ints: it calls no tensor method."""
    def refuse(*a, **k):
        raise AssertionError("the plan touched a tensor")
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    plan = masked_compact_plan(16, 2048, 1024, 2048)
    assert plan.blocks >= 2 * 132


# ---------------------------------------------------------------------------
# (b) the port against the JAX package on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,D,K", [(2, 100, 32, 150), (3, 1, 16, 1), (3, 1, 16, 4),
                                     (2, 200, 24, 120), (2, 333, 8, 333)],
                         ids=["K>S", "S=1", "S=1,K>S", "S=200", "S=333,K=S"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_compact_matches_jax_ref_off_pallas_shapes(B, S, D, K, dtype, test_seed):
    """Shapes the Pallas kernel's S % s_block assert rules out: against
    the JAX oracle, bit for bit."""
    rng = np.random.default_rng(test_seed)
    toks = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = _mask(rng, B, S)
    mask[0, 0] = True
    t = torch.from_numpy(toks).to(getattr(torch, dtype))
    out, idx, cnt = ops.masked_compact(t, torch.from_numpy(mask), K)
    o, i, c = jref.masked_compact_ref(jnp.asarray(toks, getattr(jnp, dtype)),
                                      jnp.asarray(mask), K)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(o, np.float32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(c))


@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "top72"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_compact_kv_hop_layout_matches_pallas(lossy, dtype, test_seed):
    """The KV hop's [L, Rt, Hkv*dh] = [2, 256, 128] tail, lossless (every
    row, K = Rt) and top-72% by row norm (make_mask, K = round(0.72 Rt)):
    the port against the Pallas kernel in interpret mode, bit for bit, and
    masked_scatter_ref restores what the JAX one does."""
    rng = np.random.default_rng(test_seed)
    L, Rt, D = 2, 256, 128
    toks = rng.standard_normal((L, Rt, D)).astype(np.float32)
    jt = jnp.asarray(toks, getattr(jnp, dtype))
    t = torch.from_numpy(toks).to(getattr(torch, dtype))
    if lossy:
        K = max(1, int(round(0.72 * Rt)))
        jm = jmasking.make_mask(jmasking.norm_scores(jt), 0.72)
        m = masking.make_mask(masking.norm_scores(t), 0.72)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    else:
        K = Rt
        jm = jnp.ones((L, Rt), bool)
        m = torch.ones((L, Rt), dtype=torch.bool)
    out, idx, cnt = ops.masked_compact(t, m, K)
    o, i, c = jops.masked_compact(jt, jm, K)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(o, np.float32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(c))
    back = ref.masked_scatter_ref(out, idx, Rt)
    want = jref.masked_scatter_ref(o, i, Rt)
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(want, np.float32))
    if not lossy:
        assert torch.equal(back, t)


# ---------------------------------------------------------------------------
# (c) the wrapper's refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["cpu", "mask-dtype", "negative-K", "shapes"])
def test_wrapper_refuses(case):
    """The wrapper launches its kernel or raises; it never runs the plain
    version, and it checks the mask's type and K before the device."""
    toks = torch.zeros(2, 8, 4)
    mask = torch.ones(2, 8, dtype=torch.bool)
    K = 4
    exc, match = ValueError, "CUDA"
    if case == "mask-dtype":
        mask, exc, match = mask.to(torch.uint8), TypeError, "torch.bool"
    elif case == "negative-K":
        K, match = -1, "capacity -1 < 0"
    elif case == "shapes":
        mask, match = mask[:, :7], "bad shapes"
    before = ops.launch_counts()["masked_compact"]
    with pytest.raises(exc, match=match):
        masked_compact_cuda(toks, mask, K)
    assert ops.launch_counts()["masked_compact"] == before
