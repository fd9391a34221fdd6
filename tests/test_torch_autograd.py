"""The port's differentiable kernel ops (``repro_torch.kernels.autograd``):
each Function's explicit backward against ``torch.autograd`` through the
plain versions, against ``jax.grad`` of the JAX package's oracles
(``repro/kernels/ref.py``), and under ``torch.autograd.gradcheck`` in
float64; ``ssm_scan_bwd_ref`` against a reverse-mode derivation written out
by hand.  Inputs are drawn with numpy from the suite seed.

Tolerances: float32 gradients within 1e-5 of each gradient's max|g| (the
same f32 arithmetic in another order); against JAX within 1e-4 of max|g|
(XLA sums in its own order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.autograd import GroupedFFN, SSMScan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda  # noqa: E402

F32_TOL = 1e-5
JAX_TOL = 1e-4


def _close(got, want, tol):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want.detach() if torch.is_tensor(want) else want,
                      np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


# ---------------------------------------------------------------------------
# grouped_ffn
# ---------------------------------------------------------------------------
def _ffn_inputs(rng, E, C, D, F, dtype=np.float32):
    buf = rng.standard_normal((E, C, D))
    wg = rng.standard_normal((E, D, F)) / np.sqrt(D)
    wu = rng.standard_normal((E, D, F)) / np.sqrt(D)
    wd = rng.standard_normal((E, F, D)) / np.sqrt(F)
    cot = rng.standard_normal((E, C, D))
    return [a.astype(dtype) for a in (buf, wg, wu, wd, cot)]


def _counts(kind, E, C):
    if kind is None:
        return None
    if kind == "zero":
        return torch.zeros(E, dtype=torch.int32)
    return torch.tensor([(3 * e + 1) % (C + 1) for e in range(E)],
                        dtype=torch.int32)


@pytest.mark.parametrize("counts_kind", [None, "ragged", "zero"])
def test_grouped_ffn_backward_matches_autograd_of_plain(counts_kind, test_seed):
    """ops.grouped_ffn's explicit backward against torch.autograd through
    ref.grouped_ffn_ref; rows at or past a count get zero dbuf though buf
    holds values there."""
    E, C, D, F = 3, 6, 8, 12
    buf, wg, wu, wd, cot = map(torch.from_numpy, _ffn_inputs(
        np.random.default_rng(test_seed), E, C, D, F))
    counts = _counts(counts_kind, E, C)
    ins = [t.clone().requires_grad_(True) for t in (buf, wg, wu, wd)]
    out = ops.grouped_ffn(*ins, counts=counts)
    assert type(out.grad_fn).__name__ == "GroupedFFNBackward"
    got = torch.autograd.grad((out * cot).sum(), ins)
    ref_ins = [t.clone().requires_grad_(True) for t in (buf, wg, wu, wd)]
    want = torch.autograd.grad((ref.grouped_ffn_ref(*ref_ins, counts) * cot).sum(),
                               ref_ins)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, F32_TOL)
    if counts is not None:
        rows = torch.arange(C)[None, :] >= counts[:, None]
        assert torch.all(got[0][rows] == 0)


def test_grouped_ffn_backward_matches_jax(test_seed):
    """Against jax.grad of the JAX package's grouped_ffn_ref (all C rows)."""
    E, C, D, F = 2, 8, 16, 24
    arrs = _ffn_inputs(np.random.default_rng(test_seed), E, C, D, F)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:4]]
    out = ops.grouped_ffn(*ins)
    got = torch.autograd.grad((out * torch.from_numpy(arrs[4])).sum(), ins)
    cot = jnp.asarray(arrs[4])
    want = jax.grad(lambda *a: jnp.sum(jref.grouped_ffn_ref(*a) * cot),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrs[:4]))
    for g, w in zip(got, want):
        _close(g, np.asarray(w), JAX_TOL)


def test_grouped_ffn_backward_keeps_dtypes(test_seed):
    """bf16 in, bf16 gradients out (accumulated in f32 inside)."""
    arrs = _ffn_inputs(np.random.default_rng(test_seed), 2, 4, 8, 8)
    ins = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
           for a in arrs[:4]]
    out = ops.grouped_ffn(*ins, counts=torch.tensor([2, 4], dtype=torch.int32))
    grads = torch.autograd.grad(out.float().sum(), ins)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4
    assert all(torch.isfinite(g.float()).all() for g in grads)


@pytest.mark.parametrize("counts_kind", [None, "ragged", "zero"])
def test_grouped_ffn_gradcheck(counts_kind, test_seed):
    E, C, D, F = 2, 3, 4, 5
    arrs = _ffn_inputs(np.random.default_rng(test_seed), E, C, D, F, np.float64)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:4]]
    counts = _counts(counts_kind, E, C)
    assert torch.autograd.gradcheck(
        lambda *a: GroupedFFN.apply(*a, counts, False), ins)


# ---------------------------------------------------------------------------
# ssm_scan
# ---------------------------------------------------------------------------
def _scan_inputs(rng, B, S, di, N, dtype=np.float32):
    decay = rng.uniform(0.5, 0.999, (B, S, di, N))
    bx = rng.standard_normal((B, S, di, N)) * 0.1
    h0 = rng.standard_normal((B, di, N))
    G = rng.standard_normal((B, S, di, N))
    g = rng.standard_normal((B, di, N))
    return [a.astype(dtype) for a in (decay, bx, h0, G, g)]


GRADS = [("both", True, True), ("h_all only", True, False),
         ("h_last only", False, True)]


def _scan_loss(h_all, h_last, G, g, use_G, use_g):
    loss = 0.0
    if use_G:
        loss = loss + (h_all * G).sum()
    if use_g:
        loss = loss + (h_last * g).sum()
    return loss


@pytest.mark.parametrize("name,use_G,use_g", GRADS)
@pytest.mark.parametrize("B,S,di,N", [(2, 7, 6, 4), (1, 1, 5, 3)])
def test_ssm_scan_backward_matches_autograd_of_plain(B, S, di, N, name, use_G,
                                                     use_g, test_seed):
    """ops.ssm_scan's explicit backward (G or g absent where the loss does
    not reach that output) against torch.autograd through the plain loop."""
    decay, bx, h0, G, g = map(torch.from_numpy, _scan_inputs(
        np.random.default_rng(test_seed), B, S, di, N))
    ins = [t.clone().requires_grad_(True) for t in (decay, bx, h0)]
    h_all, h_last = ops.ssm_scan(*ins)
    assert type(h_all.grad_fn).__name__ == "SSMScanBackward"
    got = torch.autograd.grad(_scan_loss(h_all, h_last, G, g, use_G, use_g), ins)
    ref_ins = [t.clone().requires_grad_(True) for t in (decay, bx, h0)]
    w_all, w_last = ref.ssm_scan_ref(*ref_ins)
    want = torch.autograd.grad(_scan_loss(w_all, w_last, G, g, use_G, use_g),
                               ref_ins)
    for a, b in zip(got, want):
        _close(a, b, F32_TOL)


def test_ssm_scan_backward_matches_jax(test_seed):
    """Against jax.grad of the JAX package's ssm_scan_ref (lax.scan)."""
    arrs = _scan_inputs(np.random.default_rng(test_seed), 2, 16, 8, 4)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:3]]
    h_all, h_last = ops.ssm_scan(*ins)
    G, g = map(torch.from_numpy, arrs[3:])
    got = torch.autograd.grad(_scan_loss(h_all, h_last, G, g, True, True), ins)
    jG, jg = map(jnp.asarray, arrs[3:])

    def jloss(decay, bx, h0):
        a, last = jref.ssm_scan_ref(decay, bx, h0)
        return jnp.sum(a * jG) + jnp.sum(last * jg)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs[:3]))
    for a, b in zip(got, want):
        _close(a, np.asarray(b), JAX_TOL)


@pytest.mark.parametrize("name,use_G,use_g", GRADS)
def test_ssm_scan_gradcheck(name, use_G, use_g, test_seed):
    arrs = _scan_inputs(np.random.default_rng(test_seed), 2, 4, 3, 2, np.float64)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:3]]

    def fn(*a):
        h_all, h_last = SSMScan.apply(*a, False)
        return tuple(o for o, use in ((h_all, use_G), (h_last, use_g)) if use)

    assert torch.autograd.gradcheck(fn, ins)


@pytest.mark.parametrize("name,use_G,use_g", GRADS)
def test_ssm_scan_bwd_ref_matches_hand_derivation(name, use_G, use_g, test_seed):
    """h_u = (prod_{t<k<=u} decay_k) h_t + ..., so by hand:
    d_bx_t = sum_{u>=t} G_u prod_{t<k<=u} decay_k + g prod_{t<k<S} decay_k,
    d_decay_t = d_bx_t h_{t-1} (h_{-1} = h0), d_h0 = decay_0 d_bx_0."""
    B, S, di, N = 2, 6, 3, 2
    decay, bx, h0, G, g = _scan_inputs(np.random.default_rng(test_seed),
                                       B, S, di, N, np.float64)
    h_all, _ = ref.ssm_scan_ref(*map(torch.from_numpy, (decay, bx, h0)))
    h_all = h_all.numpy()
    Gm = G if use_G else np.zeros_like(G)
    gm = g if use_g else np.zeros_like(g)
    d_bx = np.zeros_like(decay)
    for t in range(S):
        for u in range(t, S):
            d_bx[:, t] += Gm[:, u] * np.prod(decay[:, t + 1:u + 1], axis=1)
        d_bx[:, t] += gm * np.prod(decay[:, t + 1:], axis=1)
    h_prev = np.concatenate([h0[:, None], h_all[:, :-1]], axis=1)
    got = ref.ssm_scan_bwd_ref(
        torch.from_numpy(decay), torch.from_numpy(h_all), torch.from_numpy(h0),
        torch.from_numpy(G) if use_G else None,
        torch.from_numpy(g) if use_g else None)
    for a, b in zip(got, (d_bx * h_prev, d_bx, decay[:, 0] * d_bx[:, 0])):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12)


def test_ssm_scan_bwd_cuda_refuses_cpu_tensors():
    """The backward's wrapper launches or raises: never the plain version."""
    ops.reset_launch_counts()
    decay = torch.rand(1, 4, 8, 2)
    h0 = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssm_scan_bwd_cuda(decay, decay, h0, decay, h0)
    ins = [t.requires_grad_(True) for t in (decay.clone(), decay.clone(), h0)]
    h_all, _ = ops.ssm_scan(*ins)
    h_all.sum().backward()
    assert ops.launch_counts()["ssm_scan_bwd"] == 0 == ssm_scan_bwd_cuda.launches
