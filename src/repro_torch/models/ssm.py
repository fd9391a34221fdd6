"""State-space (Mamba) blocks: the JAX package's ``repro/models/ssm.py``.

Mamba-1 (falcon-mamba): diagonal input-independent A [d_inner, N] with
input-dependent B/C/Δ.  The prefill scan builds the ``[B,C,di,N]`` decay
and input terms one chunk at a time and runs the recurrence through
``ops.ssm_scan``: the hand-written CUDA kernel on the card, its sequential
plain version elsewhere.  JAX's associative scan is not carried over.

Mamba-2 (zamba2): scalar-A-per-head SSD formulation, intra-chunk
attention-like products plus inter-chunk state passing.

Both have a single-step form for decode with carried (conv_state,
ssm_state).  Params are L-stacked like every port stack.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import normal_stack


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _dt_bias(gen, shape, device) -> torch.Tensor:
    """softplus^-1 of U(0.001, 0.1), clipped at 1e-4, in f32."""
    u = torch.rand(shape, generator=gen, device=device) * 0.099 + 0.001
    return torch.log(torch.expm1(u.clamp(min=1e-4)))


def mamba_init(gen: torch.Generator, cfg, dtype, device, n_layers: int) -> dict:
    """L-stacked Mamba params with JAX's leaves, shapes, dtypes and init
    scales (``D``, ``dt_bias`` and ``A_log`` in f32)."""
    d, di, n, L = cfg.d_model, cfg.d_inner, cfg.ssm_state, n_layers

    def normal(shape, scale):
        return normal_stack(gen, (L, *shape), scale, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    p = {"in_proj": normal((d, 2 * di), 1.0 / math.sqrt(d)),
         "conv_w": normal((cfg.ssm_conv, di), 0.5),
         "conv_b": torch.zeros((L, di), dtype=dtype, device=device),
         "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
         "D": torch.ones((L, di), **f32)}
    if cfg.mamba_version == 1:
        r = cfg.ssm_dt_rank
        a = torch.arange(1, n + 1, **f32).expand(L, di, n)
        p.update({"x_proj": normal((di, r + 2 * n), 1.0 / math.sqrt(di)),
                  "dt_proj": normal((r, di), 1.0 / math.sqrt(r)),
                  "dt_bias": _dt_bias(gen, (L, di), device),
                  "A_log": torch.log(a)})
    else:  # mamba2 (SSD): scalar A per head, shared B/C group
        h = di // cfg.ssm_head_dim
        p.update({"bc_proj": normal((di, 2 * n), 1.0 / math.sqrt(di)),
                  "dt_bias": _dt_bias(gen, (L, h), device),
                  "dt_proj": normal((di, h), 1.0 / math.sqrt(di)),
                  "A_log": torch.log(torch.arange(1, h + 1, **f32)).expand(L, h).clone(),
                  "D": torch.ones((L, h), **f32)})
    return p


def mamba_state_shapes(cfg, batch: int):
    """(conv_state, ssm_state) shapes for one layer."""
    di, n = cfg.d_inner, cfg.ssm_state
    conv = (batch, cfg.ssm_conv - 1, di)
    if cfg.mamba_version == 1:
        ssm = (batch, di, n)
    else:
        h = di // cfg.ssm_head_dim
        ssm = (batch, h, cfg.ssm_head_dim, n)
    return conv, ssm


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------
def _causal_conv(u, w, b, conv_state=None):
    """u: [B,S,di]; w: [W,di].  Returns (silu(y + b), new_state [B,W-1,di]),
    the state being the last W-1 rows of ``[conv_state; u]``."""
    W = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype,
                                 device=u.device)
    ext = torch.cat([conv_state, u], dim=1)                  # [B,S+W-1,di]
    S = u.shape[1]
    y = ext[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + ext[:, i:i + S] * w[i]
    new_state = ext[:, -(W - 1):] if W > 1 else conv_state
    return F.silu(y + b), new_state


# ---------------------------------------------------------------------------
# Mamba-1: chunked scan through ops.ssm_scan
# ---------------------------------------------------------------------------
def mamba1_scan(u, delta, A, Bm, Cm, D, h0=None, chunk: int = 256,
                out_dtype=torch.float32, *, use_kernels: bool = False):
    """u,delta: [B,S,di]; A: [di,N]; Bm,Cm: [B,S,N]; h0: [B,di,N].
    Returns (y [B,S,di] in ``out_dtype``, h_last [B,di,N] f32).

    decay = exp(Δ·A) and bx = (Δ·u)⊗B are built in f32 one chunk at a time,
    so the [B,·,di,N] expansion exists for one chunk only; each chunk's
    recurrence is one ``ops.ssm_scan`` call."""
    B, S, di = u.shape
    N = A.shape[1]
    if h0 is None:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=u.device)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mamba1_scan: S={S} is not a multiple of chunk={chunk}")
    h = h0
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        uc, dc, bc, cc = u[:, sl], delta[:, sl], Bm[:, sl], Cm[:, sl]
        decay = torch.exp(dc[..., None] * A[None, None])     # [B,C,di,N]
        bx = (dc * uc)[..., None] * bc[:, :, None, :]        # [B,C,di,N]
        h_all, h = ops.ssm_scan(decay, bx, h.contiguous(), use_kernels=use_kernels)
        del decay, bx
        y = torch.einsum("bsdn,bsn->bsd", h_all, cc) + D * uc
        del h_all
        ys.append(y.to(out_dtype))
    return torch.cat(ys, dim=1), h


def mamba1_step(u, delta, A, Bm, Cm, D, h):
    """Single decode step.  u,delta: [B,di]; Bm,Cm: [B,N]; h: [B,di,N]."""
    decay = torch.exp(delta[..., None] * A[None])
    h = decay * h + (delta * u)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm) + D * u
    return y, h


# ---------------------------------------------------------------------------
# Mamba-2: SSD (chunked matmul formulation)
# ---------------------------------------------------------------------------
def mamba2_ssd(x, dt, A, Bm, Cm, D, h0=None, chunk: int = 256,
               out_dtype=torch.float32):
    """x: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative);
    Bm,Cm: [B,S,N]; h0: [B,H,P,N].  Returns (y [B,S,H,P], h_last)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mamba2_ssd: S={S} is not a multiple of chunk={chunk}")
    if h0 is None:
        h0 = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    h = h0
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc = x[:, sl].float(), dt[:, sl]
        bc, cc = Bm[:, sl].float(), Cm[:, sl].float()
        cum = torch.cumsum(dtc * A, dim=1)                   # [B,C,H] (<=0)
        # intra-chunk: Y[t] = sum_{s<=t} exp(cum_t - cum_s) (C_t·B_s) dt_s x_s
        li = cum[:, :, None, :] - cum[:, None, :, :]         # [B,C,C,H]
        # mask before exp: the upper triangle holds positive arguments
        Lm = torch.exp(li.masked_fill(~tri, -math.inf))
        cb = torch.einsum("btn,bsn->bts", cc, bc)            # [B,C,C]
        w = Lm * cb[..., None]                               # [B,C,C,H]
        y_intra = torch.einsum("btsh,bsh,bshp->bthp", w, dtc, xc)
        # inter-chunk: Y[t] += exp(cum_t) C_t · h_in
        y_inter = torch.einsum("bth,btn,bhpn->bthp", torch.exp(cum), cc, h)
        # state update: h' = exp(cum_last) h + sum_s exp(cum_last-cum_s) dt_s B_s x_s
        seg = torch.exp(cum[:, -1:, :] - cum)                # [B,C,H]
        h = (torch.exp(cum[:, -1])[:, :, None, None] * h
             + torch.einsum("bsh,bsn,bshp->bhpn", seg * dtc, bc, xc))
        ys.append((y_intra + y_inter).to(out_dtype))
    y = torch.cat(ys, dim=1)
    y = y + (D[None, None, :, None] * x.float()).to(out_dtype)
    return y, h


def mamba2_step(x, dt, A, Bm, Cm, D, h):
    """x: [B,H,P]; dt: [B,H]; Bm,Cm: [B,N]; h: [B,H,P,N]."""
    decay = torch.exp(dt * A[None])                          # [B,H]
    h = decay[..., None, None] * h + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bm.float(), x.float())
    y = torch.einsum("bhpn,bn->bhp", h, Cm.float())
    return y + D[None, :, None] * x.float(), h


# ---------------------------------------------------------------------------
# Full block forward
# ---------------------------------------------------------------------------
def mamba_apply(params, x, cfg, *, state=None, mode: str = "full",
                scan_chunk: int = 256, use_kernels: bool = False):
    """x: [B,S,D] ("full") or [B,1,D] ("decode").
    state: None or (conv_state, ssm_state).  Returns (y, new_state)."""
    B = x.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state
    conv_state, ssm_state = state if state is not None else (None, None)

    uz = x @ params["in_proj"]
    u, z = uz.chunk(2, dim=-1)                               # [B,S,di] each
    u, conv_new = _causal_conv(u, params["conv_w"], params["conv_b"], conv_state)

    if cfg.mamba_version == 1:
        A = -torch.exp(params["A_log"])                      # [di,N]
        dbc = u @ params["x_proj"]
        r = cfg.ssm_dt_rank
        dt_r, Bm, Cm = dbc.split([r, n, n], dim=-1)
        delta = F.softplus((dt_r @ params["dt_proj"]).float() + params["dt_bias"])
        uf = u.float()
        Bf, Cf = Bm.float(), Cm.float()
        if mode == "full":
            y, h_last = mamba1_scan(uf, delta, A, Bf, Cf, params["D"], ssm_state,
                                    chunk=scan_chunk, out_dtype=x.dtype,
                                    use_kernels=use_kernels)
        else:
            y, h_last = mamba1_step(uf[:, 0], delta[:, 0], A, Bf[:, 0],
                                    Cf[:, 0], params["D"], ssm_state)
            y = y[:, None]
    else:
        H, P = di // cfg.ssm_head_dim, cfg.ssm_head_dim
        A = -torch.exp(params["A_log"])                      # [H]
        Bm, Cm = (u @ params["bc_proj"]).chunk(2, dim=-1)
        dt = F.softplus((u @ params["dt_proj"]).float() + params["dt_bias"])
        xh = u.reshape(B, -1, H, P)
        if mode == "full":
            y, h_last = mamba2_ssd(xh, dt, A, Bm, Cm, params["D"], ssm_state,
                                   chunk=scan_chunk, out_dtype=x.dtype)
            y = y.reshape(B, -1, di)
        else:
            y, h_last = mamba2_step(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                    params["D"], ssm_state)
            y = y.reshape(B, 1, di)

    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], (conv_new, h_last)
