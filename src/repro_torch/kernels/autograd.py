"""Differentiable ``grouped_ffn`` and ``ssm_scan``: one
``torch.autograd.Function`` per op, on every device.

The kernels are bound through ctypes on raw pointers, so autograd cannot see
into them: their outputs would carry no ``grad_fn``.  Each Function's
forward routes as ``ops`` always has (the hand-written CUDA kernel for a
CUDA tensor with kernels on, else the plain version) and its backward is
written out, so the CPU tests run the same backward arithmetic as the card.

- ``GroupedFFN``: with ``a = buf·wg``, ``b = buf·wu``, ``h = silu(a)⊙b``:
  ``dwd = hᵀ·dy``, ``dh = dy·wdᵀ``, ``da = dh⊙b⊙silu'(a)``,
  ``db = dh⊙silu(a)``, ``dbuf = da·wgᵀ + db·wuᵀ``, ``dwg = bufᵀ·da``,
  ``dwu = bufᵀ·db``: ``torch.bmm`` over ``[E,C,·]`` in f32 (f64 inputs in
  f64), each result in its input's dtype.  Rows at or past ``counts[e]``
  are zero in ``buf`` and ``dy`` (the kernel reads them as zeros and writes
  zero rows there).  JAX leaves this gradient to XLA as the transpose of
  ``_moe_global``'s einsums; no Pallas kernel of the repo computes it.
- ``SSMScan``: the reverse walk of the recurrence, the hand-written CUDA
  kernel ``repro_ssm_scan_bwd`` on the card (where JAX differentiates its
  associative scan in XLA), :func:`ref.ssm_scan_bwd_ref` elsewhere.  Either
  output's gradient may be absent.

On the meta device (the dry run) each forward and the recurrence's
backward return empty outputs of the kernel's shapes, as the card's
wrappers would, and record the call's ``kernels/costs.py`` cost
(``ops``' module docstring); ``GroupedFFN``'s backward is operators, which
run on the meta device as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import costs, ref
from repro_torch.kernels.grouped_ffn import grouped_ffn_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda, ssm_scan_cuda


def ffn_cost(buf, wg, counts) -> costs.Cost:
    """A ``grouped_ffn`` call's cost: over the rows below ``counts`` and the
    experts with a row (read back on the card, only while a counter is
    active), over every row of the buffer without counts or on the meta
    device (whose counts hold no data)."""
    E, C, D = buf.shape
    rows = used = None
    if counts is not None and not counts.is_meta:
        c = counts.clamp(0, C)
        rows, used = int(c.sum()), int((c > 0).sum())
    return costs.grouped_ffn(E, C, D, wg.shape[2], buf.element_size(),
                             routed_rows=rows, experts_used=used,
                             counts=counts is not None)


class GroupedFFN(torch.autograd.Function):
    """apply(buf, wg, wu, wd, counts, use_kernels) -> [E,C,D]."""

    @staticmethod
    def forward(ctx, buf, wg, wu, wd, counts, use_kernels: bool):
        if use_kernels and (buf.is_cuda or buf.is_meta):
            out = costs.counted(
                "grouped_ffn",
                lambda: torch.empty_like(buf) if buf.is_meta
                else grouped_ffn_cuda(buf, wg, wu, wd, counts),
                lambda _: ffn_cost(buf, wg, counts))
        else:
            out = ref.grouped_ffn_ref(buf, wg, wu, wd, counts)
        ctx.save_for_backward(buf, wg, wu, wd, counts)
        return out

    @staticmethod
    def backward(ctx, dy):
        buf, wg, wu, wd, counts = ctx.saved_tensors
        acc = torch.promote_types(buf.dtype, torch.float32)   # f64 stays f64
        x, dy = buf.to(acc), dy.to(acc)
        if counts is not None:
            rows = torch.arange(buf.shape[1], device=buf.device)
            live = (rows[None, :] < counts[:, None])[..., None]
            x = torch.where(live, x, 0.0)
            dy = torch.where(live, dy, 0.0)
        wgf, wuf, wdf = wg.to(acc), wu.to(acc), wd.to(acc)
        a = torch.bmm(x, wgf)
        b = torch.bmm(x, wuf)
        sig = torch.sigmoid(a)
        silu = a * sig
        dwd = torch.bmm((silu * b).transpose(1, 2), dy)
        dh = torch.bmm(dy, wdf.transpose(1, 2))
        da = dh * b * (sig * (1.0 + a * (1.0 - sig)))
        db = dh * silu
        dbuf = torch.bmm(da, wgf.transpose(1, 2)) + torch.bmm(db, wuf.transpose(1, 2))
        xt = x.transpose(1, 2)
        return (dbuf.to(buf.dtype), torch.bmm(xt, da).to(wg.dtype),
                torch.bmm(xt, db).to(wu.dtype), dwd.to(wd.dtype), None, None)


class SSMScan(torch.autograd.Function):
    """apply(decay, bx, h0, use_kernels) -> (h_all, h_last)."""

    @staticmethod
    def forward(ctx, decay, bx, h0, use_kernels: bool):
        ctx.kernel = bool(use_kernels and (decay.is_cuda or decay.is_meta))
        if ctx.kernel:
            h_all, h_last = costs.counted(
                "ssm_scan",
                lambda: (torch.empty_like(decay), torch.empty_like(h0))
                if decay.is_meta else ssm_scan_cuda(decay, bx, h0),
                lambda _: costs.ssm_scan(*decay.shape))
        else:
            h_all, h_last = ref.ssm_scan_ref(decay, bx, h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(decay, h0, h_all)
        return h_all, h_last

    @staticmethod
    def backward(ctx, G, g):
        if G is None and g is None:
            return None, None, None, None
        decay, h0, h_all = ctx.saved_tensors
        if ctx.kernel:
            def run():
                if decay.is_meta:
                    return (torch.empty_like(decay), torch.empty_like(decay),
                            torch.empty_like(h0))
                return ssm_scan_bwd_cuda(
                    decay, h_all, h0, None if G is None else G.contiguous(),
                    None if g is None else g.contiguous())
            d_decay, d_bx, d_h0 = costs.counted(
                "ssm_scan_bwd", run, lambda _: costs.ssm_scan_bwd(
                    *decay.shape, G=G is not None, g=g is not None))
        else:
            d_decay, d_bx, d_h0 = ref.ssm_scan_bwd_ref(decay, h_all, h0, G, g)
        return d_decay, d_bx, d_h0, None
