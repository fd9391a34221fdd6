#!/usr/bin/env python3
"""Rehearse chip_smoke.py's mesh phases on the CPU, without a card.

    python3 tools/rehearse_mesh_phases.py [PHASE ...]

PHASE is mesh_seq, mesh_gqa16, mesh_moe, a mesh-train phase (mesh_train,
mesh_train_moe, mesh_train_ssm) or any family phase of
``chip_smoke.MESH_FAMILIES`` (default: mesh_dcut and mesh_gqa16).  Every
rank process (spawned over gloo, one intra-op thread each) and this one
first apply the same patches: ``configs.base.get_config`` hands out the
``reduced()`` bf16 config under the full name, with heads and vocabulary
chosen so the "model" cuts are the card's (llama3.2-1b 32 / 8 heads of
16: Case Q on 16 ranks; internvl2-1b 14 / 2 heads of 16 and a 509-row
vocabulary: Case D on 4); the kernel wrappers route CPU tensors to their
plain versions and count the launches as the CUDA ones do (grouped_ffn
and ssm_scan through the forwards of ``kernels/autograd.py``, which test
``is_cuda``); the ``torch.cuda`` calls are no-ops and its events read the
host clock; ``chip_smoke._rank_env`` builds the mesh on the CPU.  Prints
chip_smoke's JSON lines (launch counts, all_reduces a step, each rank's
walls and collective seconds) and the seconds of each phase.  A check
that fails exits non-zero as on the card.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

# the heads and vocabulary that put the reduced configs on the card's cuts
CUT_HEADS = {"llama3.2-1b": dict(num_heads=32, num_kv_heads=8, head_dim=16),
             "internvl2-1b": dict(num_heads=14, num_kv_heads=2, head_dim=16,
                                  vocab_size=509)}


def patch() -> None:
    """Route this process's card calls to the CPU (once a process)."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.configs import base
    from repro_torch.kernels import autograd, ops, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.grouped_ffn import grouped_ffn_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda, ssm_scan_cuda
    from repro_torch.kernels.masked_compact import masked_compact_cuda
    from repro_torch.launch import mesh as lmesh
    from repro_torch.serving import engine, prefill
    from repro_torch.training import train
    if getattr(base, "_rehearsed", False):
        return
    base._rehearsed = True
    full_config = base.get_config

    def get_config(name):
        return dataclasses.replace(base.reduced(full_config(name)),
                                   dtype="bfloat16", **CUT_HEADS.get(name, {}))

    def decode_attention_counted(q, k, v, cache_len, **kw):
        decode_attention_cuda.launches += 1
        return ref.decode_attention_ref(q, k, v, cache_len, **kw)

    def masked_compact_counted(tokens, mask, capacity):
        masked_compact_cuda.launches += 1
        return ref.masked_compact_ref(tokens, mask, capacity)

    def grouped_ffn_counted(buf, wg, wu, wd, counts):
        grouped_ffn_cuda.launches += 1
        return ref.grouped_ffn_ref(buf, wg, wu, wd, counts)

    def ssm_scan_counted(decay, bx, h0):
        ssm_scan_cuda.launches += 1
        return ref.ssm_scan_ref(decay, bx, h0)

    def ssm_scan_bwd_counted(decay, h_all, h0, G, g):
        ssm_scan_bwd_cuda.launches += 1
        return ref.ssm_scan_bwd_ref(decay, h_all, h0, G, g)

    def ffn_forward(ctx, buf, wg, wu, wd, counts, use_kernels):
        out = autograd.grouped_ffn_cuda(buf, wg, wu, wd, counts) \
            if use_kernels else ref.grouped_ffn_ref(buf, wg, wu, wd, counts)
        ctx.save_for_backward(buf, wg, wu, wd, counts)
        return out

    def scan_forward(ctx, decay, bx, h0, use_kernels):
        ctx.kernel = bool(use_kernels)
        h_all, h_last = autograd.ssm_scan_cuda(decay, bx, h0) \
            if use_kernels else ref.ssm_scan_ref(decay, bx, h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(decay, h0, h_all)
        return h_all, h_last

    class Event:                      # torch.cuda.Event on the host clock
        def __init__(self, *a, **k):
            self.t = 0.0

        def record(self, *a):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return 1e3 * (end.t - self.t)

    def decode_attention(q, k, v, cache_len, *, window=0, start=None,
                         lse=False, use_kernels=True):
        if not use_kernels:
            return ref.decode_attention_ref(q, k, v, cache_len, window=window,
                                            start=start, lse=lse)
        return ops.decode_attention_cuda(q.contiguous(), k, v, cache_len,
                                         window=window, start=start, lse=lse)

    def masked_compact(tokens, mask, capacity, *, use_kernels=True):
        if not use_kernels:
            return ref.masked_compact_ref(tokens, mask, capacity)
        return ops.masked_compact_cuda(tokens, mask, capacity)

    def resolve(use_kernels, device):
        return True if use_kernels == "auto" else bool(use_kernels)

    def rank_env(shape):
        torch.set_num_threads(1)
        mesh = lmesh.Mesh(np.arange(int(np.prod(shape))).reshape(shape),
                          ("data", "model"))
        return torch, torch.device("cpu"), mesh

    base.get_config = get_config
    ops.decode_attention_cuda = decode_attention_counted
    ops.masked_compact_cuda = masked_compact_counted
    ops.decode_attention = decode_attention
    ops.masked_compact = masked_compact
    autograd.grouped_ffn_cuda = grouped_ffn_counted
    autograd.ssm_scan_cuda = ssm_scan_counted
    autograd.ssm_scan_bwd_cuda = ssm_scan_bwd_counted
    autograd.GroupedFFN.forward = staticmethod(ffn_forward)
    autograd.SSMScan.forward = staticmethod(scan_forward)
    torch.cuda.Event = Event
    for mod in (ops, engine, prefill, train):
        mod.resolve_use_kernels = resolve
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache",
                 "set_device"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    chip_smoke._rank_env = rank_env


def patched_rank(rank, world, fn, *args):
    """A spawned rank: the patches, then chip_smoke's rank function."""
    patch()
    return fn(rank, world, *args)


def main() -> None:
    patch()
    import torch

    import chip_smoke
    from repro_torch.distributed import spawn
    run_ranks = spawn.run_ranks

    def rehearsal_ranks(fn, world, *args, **kw):
        kw["threads"] = 1
        return run_ranks(patched_rank, world, fn, *args, **kw)

    spawn.run_ranks = rehearsal_ranks
    dev = torch.device("cpu")
    phases = sys.argv[1:] or ["mesh_dcut", "mesh_gqa16"]
    t0 = time.perf_counter()
    for phase in phases:
        if phase == "mesh_seq":
            chip_smoke.timed(phase, chip_smoke.phase_mesh_seq, torch, dev)
        elif phase == "mesh_gqa16":
            chip_smoke.timed(phase, chip_smoke.phase_mesh_gqa16, torch, dev)
        elif phase == "mesh_moe":
            chip_smoke.timed(phase, chip_smoke.phase_mesh_moe, torch, dev)
        elif phase.startswith("mesh_train"):
            chip_smoke.timed(phase, chip_smoke.phase_mesh_train, torch, dev,
                             phase)
        else:
            chip_smoke.timed(phase, chip_smoke.phase_mesh_family, torch, dev,
                             phase)
    print(f"rehearsed {phases} in {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
