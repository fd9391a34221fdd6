"""Wrapper of the hand-written CUDA prefill-attention kernel (flash attention).

The kernel (``csrc/prefill_attention.cu``) replaces no Pallas kernel: the
JAX package computes prefill attention in XLA.  It computes
:func:`repro_torch.models.attention.chunked_attention`'s function -- GQA
self- or cross-attention over a whole prompt, its masks from the query and
key positions -- on the tensor cores, skipping the key tiles the mask wholly
hides.  ``models/attention.py`` sends a call here unless :func:`refusal`
names a reason; everything else stays on ``chunked_attention``.

The host side is the launch plan: query tiles of ``BLOCK_Q`` rows, issued
longest-first, and per query tile the key tiles of ``BLOCK_K`` rows it
visits, each wholly unmasked or masked element-wise (:func:`key_tiles`, the
rule the kernel applies to the positions on the device).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 80, 128)   # head widths the kernel takes (q, k and v alike)
MLA_DIMS = (192, 128)       # and q/k 192 with v 128: MLA's expanded prefill
BLOCK_Q = 64                # kBM in the CUDA source: query rows a block
BLOCK_K = 64                # kBN: keys a tile
STAGES = 2                  # kStages: K/V ring slots
SENTINEL = 2 ** 30          # a padded key's position
SMEM_LIMIT = 232448         # bytes of shared memory one Hopper block may use


OFF_CARD = "not on one CUDA device"


def refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take a call's tensors, or None where it
    does: bf16 all, head widths it holds (:func:`takes_widths`), no
    gradient wanted, a key range that fits a block's shared memory, all on
    one CUDA device (:data:`OFF_CARD`, asked last).  Every call refused
    (training's forward, the meta device's dry run, the CPU, f32) keeps the
    plain version."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        return "a gradient is wanted"
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return f"dtypes {q.dtype}, {k.dtype}, {v.dtype}, not bfloat16"
    if not takes_widths(q.shape[-1], v.shape[-1]):
        return (f"head_dim {q.shape[-1]} (v {v.shape[-1]}) not in "
                f"{HEAD_DIMS} alike or {MLA_DIMS}")
    if q.numel() == 0 or k.numel() == 0:
        return "no query or no key"
    if smem_bytes(q.shape[-1], k.shape[1], v.shape[-1]) > SMEM_LIMIT:
        return f"{k.shape[1]} keys overflow a block's shared memory"
    if not (q.is_cuda and k.device == q.device == v.device):
        return OFF_CARD
    return None


def takes_widths(dh: int, dv: int) -> bool:
    """Whether the kernel has an instance for q/k width ``dh`` and v width
    ``dv``."""
    return (dh == dv and dh in HEAD_DIMS) or (dh, dv) == MLA_DIMS


def smem_bytes(dh: int, Sk: int, dv: int = None) -> int:
    """Dynamic shared memory of one block (``smem_bytes_of`` in the CUDA
    source): the q tile and the K ring of ``dh``-wide rows and the V ring
    of ``dv``-wide ones (``dh`` unless given), rows padded by 16 bytes off
    bank conflicts, then the visit list, an int a key tile."""
    dv = dh if dv is None else dv
    return (BLOCK_Q + STAGES * BLOCK_K) * (2 * dh + 16) \
        + STAGES * BLOCK_K * (2 * dv + 16) + 4 * -(-Sk // BLOCK_K)


def launch_order(Sq: int) -> List[int]:
    """The query tiles in the order the kernel's blocks take them (block x
    takes tile ``nqt - 1 - x // (B * H)``): the last first, as under a
    causal mask a later tile sees more keys."""
    return list(range(-(-Sq // BLOCK_Q) - 1, -1, -1))


def key_tiles(q_positions, kv_positions, causal: bool,
              window: int) -> List[List[Tuple[int, bool]]]:
    """Per query tile, the key tiles the kernel visits, in order, each with
    whether it is masked element-wise: the kernel's rule on the positions
    (int sequences or tensors).  A key tile is skipped when the mask hides
    it wholly -- no key below the sentinel, every key after the tile's last
    query (causal), or every key a window or more before its first query --
    and taken whole when every one of its keys is below the sentinel, at or
    before the tile's first query (causal), and less than a window before
    its last query."""
    qp = [int(p) for p in q_positions]
    kp = [int(p) for p in kv_positions]
    Sq, Sk = len(qp), len(kp)
    plan = []
    for q0 in range(0, Sq, BLOCK_Q):
        rows = qp[q0:q0 + BLOCK_Q]
        qlo, qhi = min(rows), max(rows)
        tiles = []
        for t, k0 in enumerate(range(0, Sk, BLOCK_K)):
            keys = [p for p in kp[k0:k0 + BLOCK_K] if p < SENTINEL]
            if not keys:
                continue
            lo, hi = min(keys), max(keys)
            if (causal and lo > qhi) or (window and qlo - hi >= window):
                continue
            whole = (len(keys) == BLOCK_K and (not causal or qlo >= hi)
                     and (not window or qhi - lo < window))
            tiles.append((t, not whole))
        plan.append(tiles)
    return plan


def prefill_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, window: int, q_positions,
                           kv_positions, out_dtype=None) -> torch.Tensor:
    """q: [B,Sq,H,dh]; k: [B,Sk,Hkv,dh]; v: [B,Sk,Hkv,dv] (bf16, on one
    CUDA device, H a multiple of Hkv, widths :func:`takes_widths` holds);
    q_positions [Sq] and kv_positions [Sk] integer tensors on that device
    (padded queries -1, padded keys 2**30).  Returns [B,Sq,H,dv] in bf16,
    or in ``out_dtype``
    float32 (the f32 result before its one rounding, for checks).  Launches
    on the current stream without a host sync and counts the launch in
    ``prefill_attention_cuda.launches``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"prefill_attention_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"prefill_attention_cuda: {name} has dtype "
                            f"{t.dtype}; the kernel takes bfloat16")
        if t.dim() != 4:
            raise ValueError(f"prefill_attention_cuda: {name} is not 4-d "
                             f"({tuple(t.shape)})")
    B, Sq, H, dh = q.shape
    Bk, Sk, Hkv, dhk = k.shape
    dv = v.shape[-1]
    if v.shape[:-1] != k.shape[:-1] or Bk != B or dhk != dh or Hkv == 0 \
            or H % Hkv:
        raise ValueError(f"prefill_attention_cuda: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not takes_widths(dh, dv):
        raise ValueError(f"prefill_attention_cuda: head_dim {dh} (v {dv}) "
                         f"unsupported (takes {HEAD_DIMS} alike or {MLA_DIMS})")
    if B == 0 or Sq == 0 or Sk == 0:
        raise ValueError(f"prefill_attention_cuda: empty call (B={B}, Sq={Sq}, "
                         f"Sk={Sk})")
    if k.device != q.device or v.device != q.device:
        raise ValueError("prefill_attention_cuda: tensors on different devices")
    if window < 0:
        raise ValueError(f"prefill_attention_cuda: window {window} < 0")
    need = smem_bytes(dh, Sk, dv)
    if need > SMEM_LIMIT:
        raise ValueError(f"prefill_attention_cuda: Sk={Sk} needs {need} bytes "
                         "of shared memory")
    pos = []
    for name, p, n in (("q_positions", q_positions, Sq),
                       ("kv_positions", kv_positions, Sk)):
        if not torch.is_tensor(p) or p.device != q.device or p.shape != (n,) \
                or p.is_floating_point():
            raise ValueError(f"prefill_attention_cuda: {name} must be an "
                             f"integer [{n}] tensor on q's device")
        pos.append(p.to(torch.int64).contiguous())
    out_dtype = out_dtype or torch.bfloat16
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"prefill_attention_cuda: out_dtype {out_dtype}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"prefill_attention_cuda: {name} is not 16-byte "
                             "aligned")
    out = torch.empty((B, Sq, H, dv), dtype=out_dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_prefill_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos[0].data_ptr(),
            pos[1].data_ptr(), out.data_ptr(), B, Sq, Sk, H, Hkv, dh, dv,
            int(bool(causal)), int(window), int(out_dtype == torch.float32),
            stream)
    _build.check(err, "prefill_attention")
    prefill_attention_cuda.launches += 1
    return out


prefill_attention_cuda.launches = 0
