"""The port's kernel entry points (CPU path) against the JAX package's
Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and its
jnp oracles.  Inputs are drawn with numpy from the suite seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MIN_SPLIT_ROWS, SMEM_LIMIT, SPLIT_ROWS, TARGET_BLOCKS, TC_HEAD_DIMS, decode_attention_cuda,
    num_splits, smem_bytes, stages, tensor_core_path)
from repro_torch.kernels.grouped_ffn import check_counts, grouped_ffn_cuda  # noqa: E402
from repro_torch.kernels.masked_compact import masked_compact_cuda  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_cuda  # noqa: E402


def _decode_inputs(rng, B, S, H, Hkv, dh):
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    cl = np.linspace(S // 4, S, B).astype(np.int32)
    cl[0] = 1                        # a one-row window
    return q, k, v, cl


# subset of tests/test_kernels.py's decode shapes (f32, cache_len >= 1)
@pytest.mark.parametrize("B,S,H,Hkv,dh,win", [
    (2, 512, 8, 2, 64, 0), (2, 512, 16, 4, 64, 128), (2, 256, 4, 1, 128, 0),
])
def test_decode_attention_matches_jax(B, S, H, Hkv, dh, win, test_seed):
    rng = np.random.default_rng(test_seed)
    q, k, v, cl = _decode_inputs(rng, B, S, H, Hkv, dh)
    mine = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(cl),
                                window=win).numpy()
    pallas = np.asarray(jops.decode_attention(q, k, v, cl, window=win))
    oracle = np.asarray(jref.decode_attention_ref(q, k, v, cl, window=win))
    np.testing.assert_allclose(mine, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mine, oracle, rtol=2e-5, atol=2e-5)


def test_decode_attention_scalar_len_and_bf16(test_seed):
    """A scalar cache_len broadcasts like a [B] one; bf16 inputs give a bf16
    output within the JAX suite's bf16 tolerance."""
    rng = np.random.default_rng(test_seed)
    q, k, v, _ = _decode_inputs(rng, 2, 256, 8, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    scalar = ops.decode_attention(tq, tk, tv, 100)
    vector = ops.decode_attention(tq, tk, tv, torch.tensor([100, 100]))
    assert torch.equal(scalar, vector)
    bf = ops.decode_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), 100)
    assert bf.dtype == torch.bfloat16
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), 100), np.float32)
    np.testing.assert_allclose(bf.float().numpy(), want, rtol=3e-2, atol=3e-2)


def test_decode_attention_empty_window_is_zero(test_seed):
    """The kernels' semantics: no valid position -> 0 (not the NaN of a
    softmax over -inf)."""
    rng = np.random.default_rng(test_seed)
    q, k, v, _ = _decode_inputs(rng, 2, 64, 4, 2, 64)
    out = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.tensor([0, 10]))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all()


# subset of tests/test_kernels.py's compaction shapes
@pytest.mark.parametrize("B,S,D,K", [(2, 256, 128, 64), (2, 384, 64, 96),
                                     (1, 256, 128, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_compact_matches_jax(B, S, D, K, dtype, test_seed):
    rng = np.random.default_rng(test_seed)
    toks = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = rng.random((B, S)) < 0.35
    jtoks = jnp.asarray(toks, getattr(jnp, dtype))
    t = torch.from_numpy(toks).to(getattr(torch, dtype))
    out, idx, cnt = ops.masked_compact(t, torch.from_numpy(mask), K)
    for fn in (jops.masked_compact, jref.masked_compact_ref):
        o, i, c = fn(jtoks, jnp.asarray(mask), K)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(c))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(o, np.float32), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kept,K", [(0, 16), (16, 16), (40, 16)],
                         ids=["zero-kept", "capacity-equals-kept", "overflow"])
def test_masked_compact_edges_and_roundtrip(kept, K, test_seed):
    """Zero kept, capacity == kept and overflow past K against the JAX
    oracle; compact -> scatter restores the kept rows exactly."""
    rng = np.random.default_rng(test_seed)
    B, S, D = 2, 64, 32
    toks = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    for b in range(B):
        mask[b, rng.choice(S, kept, replace=False)] = True
    out, idx, cnt = ops.masked_compact(torch.from_numpy(toks),
                                       torch.from_numpy(mask), K)
    o, i, c = jref.masked_compact_ref(toks, mask, K)
    assert torch.equal(out, torch.from_numpy(np.array(o)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i))
    np.testing.assert_array_equal(cnt.numpy(), np.minimum(mask.sum(1), K))
    back = ref.masked_scatter_ref(out, idx, S).numpy()
    want = np.asarray(jref.masked_scatter_ref(o, i, S))
    np.testing.assert_array_equal(back, want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: never the plain version."""
    q = torch.zeros(1, 1, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        decode_attention_cuda(q, kv, kv, 3)
    with pytest.raises(ValueError, match="CUDA"):
        masked_compact_cuda(torch.zeros(1, 8, 4), torch.ones(1, 8, dtype=torch.bool), 4)
    w = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        grouped_ffn_cuda(torch.zeros(2, 4, 8), w, w, torch.zeros(2, 16, 8))
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssm_scan_cuda(torch.zeros(1, 4, 8, 2), torch.zeros(1, 4, 8, 2),
                      torch.zeros(1, 8, 2))
    assert ops.launch_counts() == {"decode_attention": 0, "masked_compact": 0,
                                   "grouped_ffn": 0, "ssm_scan": 0}


def test_kernel_library_names_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load()


def _ffn_inputs(rng, E, C, D, F):
    """buf and weights at the MoE init scales (tests/test_kernels.py's)."""
    buf = (rng.standard_normal((E, C, D)) * 0.3).astype(np.float32)
    wg = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    return buf, wg, wu, wd


FFN_TOL = {"float32": 2e-4, "bfloat16": 5e-2}     # tests/test_kernels.py:129


# tests/test_kernels.py's grouped_ffn shapes
@pytest.mark.parametrize("E,C,D,F", [(4, 256, 128, 512), (2, 128, 256, 1024),
                                     (8, 128, 64, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_matches_jax(E, C, D, F, dtype, test_seed):
    """The plain version against the Pallas kernel (interpret mode) and the
    JAX oracle; bf16 inputs round identically in both packages."""
    rng = np.random.default_rng(test_seed)
    arrs = _ffn_inputs(rng, E, C, D, F)
    mine = ops.grouped_ffn(*(torch.from_numpy(a).to(getattr(torch, dtype))
                             for a in arrs))
    assert mine.dtype == getattr(torch, dtype) and mine.shape == (E, C, D)
    jarrs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tol = FFN_TOL[dtype]
    for fn in (jops.grouped_ffn, jref.grouped_ffn_ref):
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(fn(*jarrs), np.float32),
                                   rtol=tol, atol=tol)


# ragged shapes the Pallas kernel refuses (C % 128, F % 512) and the CUDA
# kernel takes: moonshot-like F = 1408 % 512 != 0 in miniature
@pytest.mark.parametrize("E,C,D,F", [(3, 12, 64, 88), (2, 1, 72, 13),
                                     (5, 13, 80, 88), (64, 8, 48, 1408)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_ragged_matches_jax_oracle(E, C, D, F, dtype, test_seed):
    rng = np.random.default_rng(test_seed)
    arrs = _ffn_inputs(rng, E, C, D, F)
    mine = ops.grouped_ffn(*(torch.from_numpy(a).to(getattr(torch, dtype))
                             for a in arrs))
    want = jref.grouped_ffn_ref(*[jnp.asarray(a, getattr(jnp, dtype)) for a in arrs])
    tol = FFN_TOL[dtype]
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_zero_rows_and_empty_experts(dtype, test_seed):
    """Empty capacity slots (zero rows) and experts that received no row
    give exactly zero output rows: the MoE combine relies on it."""
    rng = np.random.default_rng(test_seed)
    buf, wg, wu, wd = (torch.from_numpy(a).to(getattr(torch, dtype))
                       for a in _ffn_inputs(rng, 4, 16, 64, 88))
    buf[:, 5:] = 0
    buf[2] = 0                                     # an expert with no rows
    out = ops.grouped_ffn(buf, wg, wu, wd)
    assert torch.equal(out[:, 5:], torch.zeros_like(out[:, 5:]))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    assert out[[0, 1, 3], :5].abs().amin(dim=-1).gt(0).any()


def test_grouped_ffn_cpu_calls_count_no_launch():
    ops.reset_launch_counts()
    w = torch.randn(2, 8, 16)
    out = ops.grouped_ffn(torch.randn(2, 4, 8), w, w, torch.randn(2, 16, 8))
    assert out.shape == (2, 4, 8)
    assert ops.launch_counts()["grouped_ffn"] == 0
    assert grouped_ffn_cuda.launches == 0


def _scan_inputs(rng, B, S, di, N):
    """tests/test_kernels.py's ssm_scan inputs: decay in [0.5, 0.999),
    bx ~ N(0, 0.1^2), h0 ~ N(0, 1)."""
    decay = rng.uniform(0.5, 0.999, (B, S, di, N)).astype(np.float32)
    bx = (rng.standard_normal((B, S, di, N)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    return decay, bx, h0


# tests/test_kernels.py's shapes, and a ragged one (S, di and N that the
# Pallas kernel's 128 / 256 blocks do not divide; the CUDA kernel masks)
@pytest.mark.parametrize("B,S,di,N", [(2, 256, 512, 16), (1, 128, 256, 8),
                                      (1, 3, 100, 3)])
def test_ssm_scan_matches_jax(B, S, di, N, test_seed):
    """The plain version against the JAX oracle and the Pallas kernel
    (interpret mode) within the JAX suite's 2e-4."""
    rng = np.random.default_rng(test_seed)
    arrs = _scan_inputs(rng, B, S, di, N)
    h_all, h_last = ops.ssm_scan(*map(torch.from_numpy, arrs))
    assert h_all.dtype == h_last.dtype == torch.float32
    assert h_all.shape == (B, S, di, N) and h_last.shape == (B, di, N)
    for fn in (jref.ssm_scan_ref, jops.ssm_scan):
        w_all, w_last = fn(*map(jnp.asarray, arrs))
        np.testing.assert_allclose(h_all.numpy(), np.asarray(w_all),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(w_last),
                                   rtol=2e-4, atol=2e-4)


def test_ssm_scan_decay_property():
    """With bx=0 the scan is a pure decay: h_T = h0 * prod(decay)."""
    B, S, di, N = 1, 128, 256, 8
    decay = torch.full((B, S, di, N), 0.99)
    _, h_last = ops.ssm_scan(decay, torch.zeros_like(decay), torch.ones(B, di, N))
    np.testing.assert_allclose(h_last.numpy(), 0.99 ** S, rtol=1e-3)


def test_ssm_scan_cpu_calls_count_no_launch():
    """A CPU tensor takes the plain version, with kernels asked for or not,
    and counts no launch."""
    ops.reset_launch_counts()
    decay = torch.rand(1, 5, 8, 4)
    h0 = torch.randn(1, 8, 4)
    for use in (True, False):
        h_all, h_last = ops.ssm_scan(decay, decay, h0, use_kernels=use)
        assert torch.equal(h_all[:, -1], h_last)
    assert ops.launch_counts()["ssm_scan"] == 0 == ssm_scan_cuda.launches


# the rows of each expert's buffer in use: none, all and ragged
@pytest.mark.parametrize("counts", [[0, 0, 0], [12, 12, 12], [0, 5, 12]],
                         ids=["zero", "full", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_counts_match_jax_on_zeroed_rows(counts, dtype, test_seed):
    """With ``counts`` the plain version equals JAX's oracle on buf with the
    rows at or past ``counts[e]`` zeroed, and those output rows are exactly
    zero though buf's rows there are not."""
    E, C, D, F = 3, 12, 64, 88
    rng = np.random.default_rng(test_seed)
    arrs = _ffn_inputs(rng, E, C, D, F)
    tdt = getattr(torch, dtype)
    mine = ops.grouped_ffn(*(torch.from_numpy(a).to(tdt) for a in arrs),
                           counts=torch.tensor(counts, dtype=torch.int32))
    zeroed = arrs[0].copy()
    for e, n in enumerate(counts):
        zeroed[e, n:] = 0
    want = jref.grouped_ffn_ref(*[jnp.asarray(a, getattr(jnp, dtype))
                                  for a in (zeroed, *arrs[1:])])
    tol = FFN_TOL[dtype]
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    for e, n in enumerate(counts):
        assert torch.equal(mine[e, n:], torch.zeros_like(mine[e, n:]))
        assert n == 0 or bool(mine[e, :n].abs().amax(dim=-1).gt(0).all())


@pytest.mark.parametrize("bad,exc,match", [
    (torch.zeros(3, dtype=torch.int32), ValueError, "shape"),
    (torch.zeros(2, 1, dtype=torch.int32), ValueError, "shape"),
    (torch.zeros(2, dtype=torch.int64), TypeError, "dtype"),
    (torch.zeros(2, dtype=torch.int32, device="meta"), ValueError, "meta"),
    ([1, 2], TypeError, "tensor"),
], ids=["length", "rank", "dtype", "device", "list"])
def test_grouped_ffn_refuses_bad_counts(bad, exc, match):
    """Both paths refuse a counts of the wrong shape, dtype or device; the
    CUDA wrapper's check holds it to buf's device."""
    w = torch.zeros(2, 8, 16)
    with pytest.raises(exc, match=match):
        ops.grouped_ffn(torch.zeros(2, 4, 8), w, w, torch.zeros(2, 16, 8),
                        counts=bad)
    with pytest.raises(exc, match=match):
        check_counts(bad, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="counts is on cpu"):
        check_counts(torch.zeros(2, dtype=torch.int32), 2, torch.device("cuda", 0))


@pytest.mark.parametrize("B,Hkv,G", [(1, 1, 1), (11, 8, 4), (11, 16, 1),
                                     (4, 32, 1), (2, 8, 16), (64, 8, 8)])
def test_num_splits_cover_every_row(B, Hkv, G):
    """The host-side split choice covers rows [0, S) at every S and leaves
    no split empty; a cache of at most MIN_SPLIT_ROWS rows is one split,
    and the splits fill the grid up to TARGET_BLOCKS blocks."""
    for S in [*range(1, 300), 511, 512, 513, 1025, 4099, 4100, 8192, 32768, 32769]:
        splits, rows = num_splits(B, Hkv, S, G)
        assert rows >= MIN_SPLIT_ROWS and rows % SPLIT_ROWS == 0
        assert splits == 1 or S > MIN_SPLIT_ROWS
        assert splits >= 1
        assert splits * rows >= S            # every row lies in a split
        assert (splits - 1) * rows < S       # the last split holds a row
        blocks = B * Hkv * -(-G // 8)
        assert blocks * (splits - 1) < TARGET_BLOCKS or splits == 1


@pytest.mark.parametrize("dh", [8, 64, 80, 128, 256])
def test_decode_attention_smem_fits_a_block(dh):
    """Every head width the wrapper takes fits one block's shared memory in
    both dtypes at the most splits num_splits gives, with at least two ring
    slots per warp."""
    most = max(num_splits(1, 1, S)[0] for S in (1, 4096, 32768, 1 << 20))
    assert most <= TARGET_BLOCKS
    for esize in (2, 4):
        if (dh * esize) % 16:
            continue
        assert stages(dh, esize) >= 2
        assert smem_bytes(dh, esize, most) <= SMEM_LIMIT
    if dh in TC_HEAD_DIMS:
        assert tensor_core_path(torch.bfloat16, dh)
        assert not tensor_core_path(torch.float32, dh)
        assert smem_bytes(dh, 2, most, tensor_cores=True) <= SMEM_LIMIT
