#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a), ``nvcc``
and PyTorch built for CUDA; imports nothing of JAX.  Phases, one JSON line
each; any failure exits non-zero before the result line:

  env      the card's name, nvidia-smi name + power limit, versions
  build    nvcc build of repro_torch/csrc/*.cu (one nvcc per source, in
           parallel) and ptxas' register / spill report
  slice    the port's launcher in-process: llama3.2-1b at full width
           (16 layers, d 2048, vocab 128256, bf16, random weights from seed
           0), 16 requests x 128 prompt tokens, 32 new tokens, --split auto
           (probe -> fit -> Eq. 4 -> masked payload -> OffloadEngine over a
           primary and an auxiliary group on the one card); checks
           decode_attention launches == layers x decode steps and
           masked_compact launches > 0
  kernels  every kernel of the main path against its plain PyTorch version
           on the card, at the batch sizes the slice ran (the probe and
           each group; S=168, H=32, Hkv=8, dh=64) plus a scalar length,
           cache_len 0 (exactly 0), lengths either side of each split
           boundary, a window smaller than one split, ragged long caches
           (S=4100, window 0 and 128) and an empty window, and a sweep over
           dh 64/80/128 x G 1/4/8; every call twice, bit-equal; bf16 within
           3e-2 and f32 within 1e-4; masked_compact bit for bit, bf16 and
           f32, at every slice's payload (d 2048 and 4096), S one tile -1,
           one tile and one tile +1, K > S, K = 0, B = S = 1, capacity ==
           kept, zero kept, overflow past K, an odd row width, long rows
           (S 32768 and 131072), both KV-hop shapes and views at storage
           offset 1 (the narrower copy paths); each call twice, bit-equal,
           and once more through the other base-finding branch
  parity   a float32 copy of the same weights: kernel path vs plain path
           logits over 8 teacher-forced decode steps within 1e-3; greedy
           streams agree up to the plain path's first top-2 gap < 1e-3;
           macro_steps=8 and 0 streams identical (bf16, kernels on)
  trace    one group's generate() under torch.profiler: device busy and
           idle share, the kernels that take the device time
  timing   each kernel, its plain version and the PyTorch library call at
           the main path's shapes, beside the bound: "ms" from CUDA events
           around a loop of calls (what a caller pays per call, host work
           included), "device_ms" from CUDA events around a loop the host
           enqueues while a device-side sleep holds the stream (the device
           work alone, back to back); loops cycle through more input sets
           than L2 holds; masked_compact also at llama3.2-1b's
           prefill->decode KV hop ([16,2048,512] bf16, lossless and top 72%),
           with the device ms of each base-finding branch

Then llama3.2-1b's params are freed and the MoE path runs:

  moe slice    the launcher in-process: moonshot-v1-16b-a3b at full width
           (48 layers, d 2048, 64 experts top-6 + 2 shared, vocab 163840,
           bf16, random weights from seed 0, 57.8 GB), the same 16 requests
           x 128 prompt tokens, 32 new tokens, --split auto; checks
           grouped_ffn launches == layers x (decode steps + prefills) and
           decode_attention launches == layers x decode steps; reports peak
           device memory
  moe kernels  grouped_ffn against its plain version at every (E, C, D, F)
           the slice ran (prefill and decode capacity of the probe and of
           each group), at ragged shapes (C 1 and 13, F 13 and 88, D 70,
           72 and 80) and with counts (0, C, ragged; rows past a count are
           exactly zero though buf's rows there are not), zero rows and
           empty experts exactly zero, every call twice, bit-equal, bf16
           within 5e-2 and f32 within 2e-4; decode_attention at moonshot's
           shape (G=1, dh=128)
  moe parity   a 2-layer float32 cut of the slice's weights at full width:
           kernel vs plain path logits over 8 teacher-forced decode steps
           within 1e-3 (a larger gap is excused only where a routing choice
           flipped at a top-k margin below 1e-6), the smallest router
           margin; macro_steps=8 and 0 streams identical (bf16, full depth)
  moe trace    one group's generate() of 16 new tokens under torch.profiler
  moe timing   grouped_ffn at decode (C=8) and at the auxiliary group's
           prefill capacity, each of the slice's 48 layers with a buffer and
           counts made by routing random tokens through its router; beside
           it the plain version and the bf16 composition of three torch.bmm
           calls and silu*mul (composition_ms; no single PyTorch call
           computes this function, so library_ms is null), and the bound
           over every expert and over the routed experts and rows;
           decode_attention at moonshot's shape
  long cache   with no weights held: decode_attention, its plain version and
           SDPA at llama's heads over a full 32768-row cache and moonshot's
           over 8192 rows, as a share of the bytes bound

Then moonshot's params are freed and the SSM path runs:

  ssm_slice    the launcher in-process: falcon-mamba-7b at full width and
           depth (64 Mamba-1 layers, d 4096, d_inner 8192, N 16, vocab
           65024, bf16, random weights from seed 0, 14.0 GB), the same 16
           requests x 128 prompt tokens, 32 new tokens, --split auto;
           checks ssm_scan launches == layers x prefills x ceil(S/256),
           decode_attention launches == 0 and masked_compact launches > 0;
           reports r*, t_parallel / t_serial, tokens/s, peak memory
  ssm_kernels  ssm_scan against its plain version at every (B, S, di, N)
           the slice ran, at ragged shapes (S 1 and 300, di 100 and 101,
           N 3) and the pure-decay case, h0 non-zero, f32 within 1e-5 of
           max|h| (both run the recurrence in one order)
  ssm_parity   a 2-layer float32 cut of the slice's weights at full width:
           kernel vs plain path prefill logits and states and 8
           teacher-forced decode steps' logits within 1e-3; macro_steps=8
           and 0 streams identical (bf16, full depth)
  ssm_trace    one group's generate() under torch.profiler
  ssm_timing   ssm_scan and its plain version at the auxiliary group's
           prefill shape ([11,128,8192,16] f32), beside the bytes bound;
           no single PyTorch call computes the recurrence (library_ms null)
  hybrid   zamba2-2.7b at full width (54 Mamba-2 layers, d 2560, the
           shared attention block every 6 layers, H=Hkv=32, dh 80, bf16,
           4.85 GB), 4 requests x 128 prompt tokens, 16 new tokens, --split
           none; checks decode_attention launches == 9 x decode steps;
           decode_attention against its plain version at dh=80 (bf16 within
           3e-2, f32 within 1e-4); macro_steps=8 and 0 streams identical

Then the per-kernel summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Every phase also prints its seconds.
Float32 matmuls run in full float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

L2_BYTES = 50e6                  # H100 L2 cache

H100_PEAK_FLOPS_F32 = 67e12      # f32 outside the tensor cores (data sheet)

ARCH = "llama3.2-1b"
MOE_ARCH = "moonshot-v1-16b-a3b"
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "zamba2-2.7b"
REQUESTS, PROMPT_LEN, MAX_NEW, MACRO = 16, 128, 32, 8
HYBRID_REQUESTS, HYBRID_MAX_NEW = 4, 16
MOE_TRACE_NEW = 16                  # moonshot's traced generate(): new tokens
S_MAIN = PROMPT_LEN + MAX_NEW + 8   # the engines' cache length
S_SPLIT = 2000                      # a cache that decode_attention splits
KV_HOP = (16, 2048, 512)            # llama3.2-1b's K (or V) tail of one
                                    # prefill->decode hop: [layers, Rt, Hkv*dh]
FFN_TOL = {"bfloat16": 5e-2, "float32": 2e-4}   # tests/test_kernels.py:129
SCAN_TOL = 1e-5     # relative to max|h|: both versions sum in one order

# nvidia-smi's name + power limit, stamped on every line after env so each
# number stands beside the card it came from
_CARD = {}


def emit(obj) -> None:
    print(json.dumps({**obj, **_CARD}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
def phase_env(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _CARD["card"] = card
    emit({"phase": "env", "device": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "tf32": False})
    return name, card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.load()._name
    info = dict(_build.build_info)
    ptxas = [ln.strip() for ln in str(info.pop("ptxas", "")).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info.get("seconds"), "cached": info.get("cached"),
          "library": str(Path(path).relative_to(ROOT)), "ptxas": ptxas})


# ---------------------------------------------------------------------------
def _decode_case(torch, gen, B, S, H, Hkv, dh, dtype, cache_len, dev):
    q = torch.randn((B, 1, H, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, dh), generator=gen, device=dev).to(dtype)
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=dev)
    return q, k, v, cl


def _batch_sizes(slice_summary):
    """The batch sizes the slice's engines ran: the probe's and each group's."""
    from repro_torch.launch.serve import PROBE_REQUESTS
    return sorted({PROBE_REQUESTS, *(n for n in slice_summary["n_group"] if n)})


def _split_boundary_lens(S, rows, B):
    """Cache lengths one row either side of each split boundary (and S), B
    of them: the ragged ends of the split-K grid."""
    lens = sorted({min(max(r + d, 1), S) for r in range(rows, S + rows, rows)
                   for d in (-1, 0, 1)})
    return (lens * B)[:B] if len(lens) < B else lens[:B - 1] + [S]


def _check_decode_attention(torch, dev, gen, main_bs, H, Hkv, dh, phase):
    """decode_attention against its plain version at [B,1,H,dh] for every
    batch size the slice ran (per-slot lengths that include 1 and S), a
    scalar length, cache_len 0 (exactly 0 out), lengths either side of the
    split boundaries, a window smaller than one split, ragged long caches
    with and without a window, and an empty window; every case twice,
    bit-equal.  Returns the largest main-path error (bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      num_splits)

    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    results, main_err = [], 0.0
    cases = []
    for B in main_bs:
        lens = torch.randint(1, S_MAIN + 1, (B,), generator=gen, device=dev)
        lens[0], lens[-1] = 1, S_MAIN
        cases.append((B, S_MAIN, 0, lens, True))
    Bm = max(main_bs)
    cases.append((Bm, S_MAIN, 0, PROMPT_LEN + 1, True))             # scalar len
    cases.append((Bm, S_MAIN, 0, [0] * Bm, False))                  # cache_len 0
    _, rows = num_splits(4, Hkv, S_SPLIT, H // Hkv)                 # several splits
    cases.append((4, S_SPLIT, 0, _split_boundary_lens(S_SPLIT, rows, 4), False))
    cases.append((8, S_SPLIT, 0, _split_boundary_lens(S_SPLIT, rows, 8), False))
    cases.append((8, S_SPLIT, max(1, rows // 2 - 1),                # window < split
                  _split_boundary_lens(S_SPLIT, rows, 8), False))
    _, rows_long = num_splits(4, Hkv, 4100, H // Hkv)
    cases.append((4, 4100, 0, [1, 777, 4099, 4100], False))       # ragged long
    cases.append((4, 4100, 128, [1, 777, 4099, 4100], False))
    cases.append((4, 4100, 0, [rows_long - 1, rows_long + 1, 3 * rows_long, 4100],
                  False))
    cases.append((3, 300, 16, [0, 5, 300], False))                # empty window
    for B, S, win, lens, main in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, cl = _decode_case(torch, gen, B, S, H, Hkv, dh, dtype,
                                       lens, dev)
            got = decode_attention_cuda(q, k, v, cl, window=win)
            again = decode_attention_cuda(q, k, v, cl, window=win)
            want = ref.decode_attention_ref(q, k, v, cl, window=win)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tag = (f"decode_attention B={B} S={S} H={H} Hkv={Hkv} dh={dh} "
                   f"window={win} {dtype}")
            require(got.dtype == dtype and bool(torch.isfinite(got).all()),
                    f"{tag}: bad output")
            require(err <= tol[dtype], f"{tag}: max_abs_err {err} > {tol[dtype]}")
            require(torch.equal(got, again), f"{tag}: two calls differ")
            empty = cl.reshape(-1).expand(B) <= 0
            require(not bool(got[empty].any()), f"{tag}: cache_len 0 gave non-zero")
            if main and dtype == torch.bfloat16:
                main_err = max(main_err, err)
            results.append({"B": B, "S": S, "window": win, "H": H, "Hkv": Hkv,
                            "dh": dh, "splits": num_splits(B, Hkv, S, H // Hkv),
                            "dtype": str(dtype)[6:], "max_abs_err": err,
                            "bit_equal_twice": True})
    emit({"phase": phase, "kernel": "decode_attention",
          "tolerance": {"bfloat16": 3e-2, "float32": 1e-4}, "cases": results})
    return main_err


def _sweep_decode_attention(torch, dev, gen):
    """decode_attention against its plain version at every head width the
    port's configs use (dh 64, 80, 128) and G 1, 4 and 8, with and without
    a window, bf16 and f32, twice each, bit-equal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    worst = {}
    for dh in (64, 80, 128):
        for G in (1, 4, 8):
            for win in (0, 40):
                for dtype in (torch.bfloat16, torch.float32):
                    q, k, v, cl = _decode_case(torch, gen, 3, 300, 4 * G, 4, dh,
                                               dtype, [0, 150, 300], dev)
                    got = decode_attention_cuda(q, k, v, cl, window=win)
                    again = decode_attention_cuda(q, k, v, cl, window=win)
                    want = ref.decode_attention_ref(q, k, v, cl, window=win)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    tag = f"decode_attention sweep dh={dh} G={G} window={win} {dtype}"
                    require(err <= tol[dtype], f"{tag}: max_abs_err {err}")
                    require(torch.equal(got, again), f"{tag}: two calls differ")
                    require(not bool(got[0].any()), f"{tag}: cache_len 0 gave non-zero")
                    key = f"dh{dh}_G{G}_{str(dtype)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), err)
    emit({"phase": "kernels", "kernel": "decode_attention", "sweep": "dh x G",
          "B": 3, "S": 300, "Hkv": 4, "lens": [0, 150, 300], "windows": [0, 40],
          "max_abs_err": worst})


def _mc_cases(B_main, tile):
    """masked_compact's checked cases: (name, B, S, D, K, mask kind, kept or
    None): the §VI payload of every slice (llama and moonshot d 2048,
    falcon-mamba d 4096), S one tile -1, one tile and one tile +1 of the
    plan's tile at the payload, K > S, K = 0, B = S = 1, capacity == kept,
    zero kept, overflow past K, an odd row width, long rows (S 32768; S
    131072, where the plan takes the count pass) and both KV-hop shapes."""
    return [("main-path", B_main, PROMPT_LEN, 2048, PROMPT_LEN, "keep72", None),
            ("payload-d4096", B_main, PROMPT_LEN, 4096, PROMPT_LEN, "keep72", None),
            ("tile-1", 3, tile - 1, 2048, tile - 1, "keep72", None),
            ("tile", 3, tile, 2048, tile, "keep72", None),
            ("tile+1", 3, tile + 1, 2048, tile + 1, "keep72", None),
            ("K>S", 3, 100, 64, 300, "keep72", None),
            ("K=0", 3, PROMPT_LEN, 2048, 0, "keep72", None),
            ("B=S=1", 1, 1, 2048, 1, "all", None),
            ("capacity-equals-kept", 5, PROMPT_LEN, 2048, 92, None, 92),
            ("zero-kept", 5, PROMPT_LEN, 2048, PROMPT_LEN, None, 0),
            ("overflow", 5, PROMPT_LEN, 2048, 32, None, 92),
            ("long-odd-width", 3, 1000, 5, 300, "keep72", None),
            ("long-row", 2, 32768, 64, 20000, "keep72", None),
            ("longest-row", 1, 131072, 64, 60000, "keep72", None),
            ("kv-hop-lossless", *KV_HOP, KV_HOP[1], "all", None),
            ("kv-hop-lossy", *KV_HOP, None, "make_mask", None)]


def _check_masked_compact(torch, dev, gen, B_main):
    """masked_compact against its plain version at every case of
    ``_mc_cases`` and on views at storage offset 1 (tokens and mask not
    16-byte aligned: the uint16, uint32 and uint8 copy paths), bf16 and f32;
    each with the plan's branch twice (bit-equal) and the other base-finding
    branch once, all bit for bit.  Returns the main path's largest error."""
    from repro_torch.kernels import masked_compact as mc
    from repro_torch.kernels import ref

    tile = mc.masked_compact_plan(B_main, PROMPT_LEN, 2048 * 2, PROMPT_LEN).tile
    cases = [(*c, dtype, 0) for c in _mc_cases(B_main, tile)
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [("offset-1", 3, 130, 2048, PROMPT_LEN, "keep72", None, dtype, 1)
              for dtype in (torch.bfloat16, torch.float32, torch.uint8)]
    results, main_err = [], 0.0
    for name, B, S, D, K, kind, kept, dtype, offset in cases:
        toks, mask, k = _mc_case(torch, gen, dev, B, S, D, kind or "all", dtype)
        K = k if K is None else K
        if kind is None:           # exactly ``kept`` rows of each batch row
            order = torch.rand((B, S), generator=gen, device=dev).argsort(dim=1)
            mask = order < kept
        if offset:                 # the same values at storage offset 1
            toks = torch.cat([toks.new_zeros(1), toks.flatten()])[1:].view(B, S, D)
            mask = torch.cat([mask.new_zeros(1), mask.flatten()])[1:].view(B, S)
        esize = toks.element_size()
        plan = mc.masked_compact_plan(B, S, D * esize, K)
        other = mc.masked_compact_plan(B, S, D * esize, K, long_rows=not plan.long_rows)
        got = mc.masked_compact_cuda(toks, mask, K)
        again = mc.masked_compact_cuda(toks, mask, K)
        branch = mc.masked_compact_cuda(toks, mask, K, plan=other)
        want = ref.masked_compact_ref(toks, mask, K)
        torch.cuda.synchronize()
        tag = f"masked_compact {name} B={B} S={S} D={D} K={K} {dtype}"
        err = float((got[0].float() - want[0].float()).abs().max()) if got[0].numel() else 0.0
        for what, res in (("plan", got), ("second call", again), ("other branch", branch)):
            require(all(torch.equal(a, b) for a, b in zip(res, want)),
                    f"{tag}: {what} differs from the plain version "
                    f"(out max_abs_err {err})")
        if name == "main-path":
            main_err = max(main_err, err)
        results.append({"case": name, "B": B, "S": S, "D": D, "K": K,
                        "dtype": str(dtype)[6:], "offset": offset,
                        "kept": int(mask.sum()), "plan": dataclasses.asdict(plan),
                        "exact": True, "bit_equal_twice": True,
                        "other_branch_exact": True, "max_abs_err": err})
        del toks, mask, got, again, branch, want
    emit({"phase": "kernels", "kernel": "masked_compact", "tolerance": "exact",
          "cases": results})
    return main_err


def phase_kernel_checks(torch, dev, slice_summary):
    """Each kernel against its plain version at the shapes the slice gave
    it (the probe's and each group's batch) and at edge cases; returns the
    largest main-path error of each kernel."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    groups = dict(zip(slice_summary["group_names"], slice_summary["n_group"]))
    main_err = _check_decode_attention(torch, dev, gen, _batch_sizes(slice_summary),
                                       32, 8, 64, "kernels")
    _sweep_decode_attention(torch, dev, gen)

    mc_err = _check_masked_compact(torch, dev, gen, groups["auxiliary"])
    return {"decode_attention": main_err, "masked_compact": mc_err}


# ---------------------------------------------------------------------------
def _expected_launches(cfg, s, prompt_len):
    """Kernel launches the slice summary ``s`` implies for ``cfg``: decode
    attention in every attention layer of every decode step (the hybrid's
    shared block once per block of Mamba layers), grouped_ffn in every MoE
    layer of every prefill and decode step, ssm_scan in every Mamba-1 layer
    of every prefill, once per 256-token chunk."""
    L, steps, prefills = cfg.num_layers, s["decode_steps"], s["prefills"]
    attn_layers = {"ssm": 0, "hybrid": L // max(cfg.hybrid_attn_every, 1)}
    scan = cfg.family == "ssm" and cfg.mamba_version == 1
    return {"decode_attention": attn_layers.get(cfg.family, L) * steps,
            "grouped_ffn": L * (steps + prefills) if cfg.num_experts else 0,
            "ssm_scan": L * prefills * -(-prompt_len // 256) if scan else 0}


def phase_slice(torch, arch=ARCH, *, phase="slice", split="auto",
                requests=REQUESTS, max_new=MAX_NEW):
    """The port's launcher in-process on ``arch``; the launch counts are
    set to 0 just before and read just after, and held against what the
    run's layers, steps and prefills imply.  Returns (summary, counts)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get_config(arch)
    argv = ["--arch", arch, "--requests", str(requests), "--prompt-len",
            str(PROMPT_LEN), "--max-new", str(max_new), "--macro-steps",
            str(MACRO), "--split", split, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    s = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = s["tokens"]
    require(toks.shape == (requests, max_new), f"tokens shape {toks.shape}")
    require(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
            "token ids out of range")
    want = _expected_launches(cfg, s, PROMPT_LEN)
    for kname, n in want.items():
        require(counts[kname] == n,
                f"{arch}: {kname} launched {counts[kname]} times, expected "
                f"{n} ({cfg.num_layers} layers, {s['decode_steps']} decode "
                f"steps, {s['prefills']} prefills)")
    comp = s.get("compression")
    if split != "none":
        require(counts["masked_compact"] > 0, "masked_compact never launched")
        require(comp["kept_tokens_compacted"] == comp["kept_tokens"],
                "masked_compact's count disagrees with the mask")
    groups = dict(zip(s["group_names"], s["n_group"])) if "n_group" in s else None
    emit({"phase": phase, "arch": arch, "argv": argv, "r_star": s.get("r_star"),
          "r": s["r"], "groups": groups, "t_group_s": s.get("t_group_s"),
          "t_parallel_s": s.get("t_parallel_s"),
          "t_serial_s": s.get("t_serial_s"), "t_offload_s": s.get("t_offload_s"),
          "probe_s": s.get("probe_s"), "tokens_per_s": s["tokens_per_s"],
          "serve_wall_s": s["wall_s"], "main_wall_s": wall,
          "decode_steps": s["decode_steps"], "prefills": s["prefills"],
          "launches": counts, "expected_launches": want,
          "peak_memory_bytes": peak,
          "payload_bytes_per_item": s.get("payload_bytes_per_item"),
          "compression": comp})
    return s, counts


# ---------------------------------------------------------------------------
def _macro_streams_equal(torch, dev, cfg, params, prompts, max_new):
    """macro_steps=8 and 0 give identical greedy streams (kernels on)."""
    from repro_torch.serving.engine import ServingEngine

    streams = {}
    for k in (MACRO, 0):
        eng = ServingEngine(cfg, params, max_len=PROMPT_LEN + max_new + 8,
                            macro_steps=k, device=dev)
        streams[k] = eng.generate(prompts, max_new).tokens
    same = bool((streams[MACRO] == streams[0]).all())
    require(same, f"{cfg.name}: macro_steps=8 and macro_steps=0 streams differ")
    return same


def phase_parity(torch, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.core.offload import tree_map
    from repro_torch.models import model as M
    from repro_torch.serving.engine import (ServingEngine, make_prefill_step,
                                            make_serve_step, seed_cache)

    cfg = get_config(ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg, 0, device=dev)           # the slice's weights
    params32 = tree_map(lambda t: t.float(), params)
    prompts = _prompts(cfg)
    B = 4
    tokens = torch.as_tensor(prompts[:B], device=dev)
    with torch.no_grad():
        last, pre = make_prefill_step(cfg32, use_kernels=False)(
            params32, {"tokens": tokens})
        caches = []
        for _ in range(2):
            c = M.init_cache(cfg32, B, S_MAIN, device=dev)
            caches.append(seed_cache(cfg32, c, pre, PROMPT_LEN))
        del pre
        plain = make_serve_step(cfg32, use_kernels=False)
        kern = make_serve_step(cfg32, use_kernels=True)
        tok = last.argmax(dim=-1).to(torch.int32)
        stream, gaps, tf_err = [tok], [_top2_gap(torch, last)], []
        for i in range(MAX_NEW - 1):
            lengths = torch.full((B,), PROMPT_LEN + i, dtype=torch.int32, device=dev)
            lp, _ = plain(params32, caches[0], tok[:, None], lengths)
            if i < 8:
                lk, _ = kern(params32, caches[1], tok[:, None], lengths)
                tf_err.append(float((lk - lp).abs().max()))
            tok = lp.argmax(dim=-1).to(torch.int32)
            stream.append(tok)
            gaps.append(_top2_gap(torch, lp))
        plain_stream = torch.stack(stream, dim=1).cpu().numpy()
        gaps = torch.stack(gaps, dim=1).cpu().numpy()
        del caches
    require(max(tf_err) <= 1e-3, f"teacher-forced logits differ by "
            f"{max(tf_err)} > 1e-3 between kernel and plain paths")

    eng = ServingEngine(cfg32, params32, max_len=S_MAIN, macro_steps=MACRO,
                        use_kernels=True, device=dev)
    kern_stream = eng.generate(prompts[:B], MAX_NEW).tokens
    first_mismatch, first_low_gap = [], []
    for b in range(B):
        diff = np.nonzero(kern_stream[b] != plain_stream[b])[0]
        low = np.nonzero(gaps[b] < 1e-3)[0]
        m = int(diff[0]) if diff.size else None
        g = int(low[0]) if low.size else None
        first_mismatch.append(m)
        first_low_gap.append(g)
        require(m is None or (g is not None and m >= g),
                f"request {b}: kernel stream leaves the plain stream at "
                f"{m} before any top-2 gap < 1e-3 (first at {g})")
    del eng
    overlap = _check_offload_streams(torch, dev, cfg32, params32, prompts)
    del params32

    same = _macro_streams_equal(torch, dev, cfg, params, prompts, MAX_NEW)
    emit({"phase": "parity", "dtype": "float32", "requests": B,
          "teacher_forced_max_abs": tf_err, "tolerance": 1e-3,
          "first_mismatch": first_mismatch, "first_top2_gap_below_1e-3": first_low_gap,
          "min_top2_gap": float(gaps.min()),
          "macro_8_equals_0": same, "macro_check_dtype": "bfloat16",
          "offload_streams": overlap})
    return cfg, params, prompts


def _prompts(cfg):
    """The launcher's prompts: request_stream(seed=0), padded or cut to
    PROMPT_LEN tokens."""
    from repro_torch.data.pipeline import request_stream
    reqs = request_stream(cfg.vocab_size, n=REQUESTS, mean_prompt=PROMPT_LEN, seed=0)
    return np.stack([np.pad(r.prompt[:PROMPT_LEN],
                            (0, max(0, PROMPT_LEN - len(r.prompt))))
                     for r in reqs]).astype(np.int32)


def _check_offload_streams(torch, dev, cfg, params, prompts):
    """OffloadEngine's dispatch-all-then-await path (jit=True: one CUDA
    stream per group, completion polled with Event.query) merges to the
    one-group result; float32 prefill logits within 1e-4."""
    import repro_torch.core as C
    from repro_torch.models import model as M

    def task(b):
        with torch.no_grad():
            out = M.forward(params, cfg, {"tokens": b["tokens"]}, mode="prefill")
        return {"logits": out.logits[:, -1]}

    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    whole = task(batch)["logits"]
    eng = C.OffloadEngine(task, C.NodeGroup("primary", [dev], C.JETSON_NANO),
                          C.NodeGroup("auxiliary", [dev], C.JETSON_XAVIER),
                          C.WIFI_5GHZ, payload_bytes_per_item=1e4, jit=True)
    rep = eng.run(batch, 0.7)
    torch.cuda.synchronize()
    err = float((rep.outputs["logits"] - whole).abs().max())
    require(rep.outputs["logits"].shape == whole.shape and err <= 1e-4,
            f"OffloadEngine(jit=True) merge differs from one group by {err}")
    require(rep.t_parallel_s > 0.0 and min(rep.t_group_s) > 0.0,
            "OffloadEngine(jit=True) did not stamp every group's completion")
    return {"n_group": rep.n_group, "t_group_s": rep.t_group_s,
            "t_parallel_s": rep.t_parallel_s, "max_abs_err": err}


def phase_trace(torch, dev, cfg, params, prompts, B, max_new=MAX_NEW):
    """Where one group's generate() spends its time: device busy share and
    the kernels that take it, from a torch.profiler trace of a warm run of
    ``max_new`` new tokens."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(cfg, params, max_len=S_MAIN, macro_steps=MACRO, device=dev)
    warm = eng.generate(prompts[:B], max_new)
    steps0 = eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts[:B], max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.decode_steps - steps0
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (us + e.device_time_total, n + 1)
    busy_s = sum(us for us, _ in per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    launches = sum(n for _, n in per_kernel.values())
    emit({"phase": "trace", "arch": cfg.name, "B": B, "prompt_len": PROMPT_LEN,
          "max_new": max_new,
          "macro_steps": MACRO, "untraced_prefill_s": warm.prefill_s,
          "untraced_decode_s": warm.decode_s,
          "untraced_ms_per_decode_step": 1e3 * warm.t_per_macro_step_s / MACRO,
          "traced_wall_s": wall, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall if busy_s else None,
          "device_launches": launches, "decode_steps": steps,
          "device_launches_per_decode_step_prefill_included": launches / steps,
          "top_kernels": [{"name": name[:90], "device_ms": us / 1e3, "calls": n}
                          for name, (us, n) in top]})


def _top2_gap(torch, logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


# ---------------------------------------------------------------------------
def _time_ms(torch, fn, arg_sets, iters=200, warmup=10):
    """Mean ms per call: CUDA events around a loop that cycles through
    ``arg_sets`` (more bytes than L2 holds, so each call finds its inputs
    cold, as the serving path does)."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, arg_sets, iters=50, need_ahead=True):
    """Mean device ms per call: CUDA events around ``iters`` calls that the
    host enqueues while a device-side sleep holds the stream, so the events
    bracket the calls' device work back to back and not the host's launch
    cost.  The host was ahead when the start event had not fired by the
    time the last call was enqueued; otherwise the sleep grows and the loop
    runs again.  Every kernel's ``device_ms`` comes from here (the profiler
    lost the events of the ctypes-launched kernels after earlier traces).
    Returns None where the host never got ahead and ``need_ahead`` is
    false (a plain version whose launches fill the launch queue)."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    per_call_s = (time.perf_counter() - t0) / 3      # host enqueue cost, or more
    torch.cuda.synchronize()
    cycles = int(2e9 * (2.0 * iters * per_call_s + 1e-3))   # ~2e9 SM cycles a second
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    require(not need_ahead, "_device_ms: the host never got ahead of the device")
    return None


def _sets_for(bytes_per_set: float) -> int:
    return max(2, math.ceil(4 * L2_BYTES / max(bytes_per_set, 1.0)))


def _bound(n_bytes, n_ops, peak_flops=None):
    """(bound_ms, bound_by): the larger of bytes over the H100's memory rate
    and operations over ``peak_flops`` (default: the bf16 tensor-core
    peak)."""
    from repro_torch.core.profiler import H100_HBM_BW, H100_PEAK_FLOPS_BF16
    t_bytes = n_bytes / H100_HBM_BW
    t_ops = n_ops / (peak_flops or H100_PEAK_FLOPS_BF16)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _time_decode_attention(torch, dev, gen, gname, B, H, Hkv, dh, S=S_MAIN,
                           cache_len=None):
    """decode_attention, its plain version and SDPA at [B,1,H,dh] against a
    bf16 cache of S rows, by default the slice's, halfway through decode."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      num_splits)

    esize = 2
    # cache_len halfway through the slice's decode unless given
    cl_mid = cache_len or PROMPT_LEN + MAX_NEW // 2 + 1
    per_set = 2 * B * S * Hkv * dh * esize
    sets = [_decode_case(torch, gen, B, S, H, Hkv, dh, torch.bfloat16,
                         [cl_mid] * B, dev) for _ in range(_sets_for(per_set))]

    def sdpa(q, k, v, cl):
        mask = (torch.arange(S, device=dev)[None] < cl[:, None])[:, None, None]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)

    q, k, v, cl = sets[0]
    lib_err = float((sdpa(q, k, v, cl).float()
                     - ref.decode_attention_ref(q, k, v, cl).float()).abs().max())
    require(lib_err <= 3e-2, f"library attention disagrees by {lib_err}")
    fns = {"": lambda *a: decode_attention_cuda(*a),
           "plain_": lambda *a: ref.decode_attention_ref(*a),
           "library_": sdpa}
    times = {f"{p}ms": _time_ms(torch, fn, sets) for p, fn in fns.items()}
    iters = {"": 100, "plain_": 10, "library_": 50}   # a few hundred launches
    times.update({f"{p}device_ms": _device_ms(torch, fn, sets, iters=iters[p],
                                              need_ahead=not p)
                  for p, fn in fns.items()})
    n_bytes = (2 * B * cl_mid * Hkv * dh * esize    # K and V rows read
               + 2 * B * H * dh * esize             # q read, out written
               + 4 * B)                             # cache_len
    n_ops = 4 * B * H * cl_mid * dh                 # q.k and p.v
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    return {"kernel": "decode_attention", "group": gname, "B": B, "S": S,
            "cache_len": cl_mid, "dtype": "bfloat16", "H": H, "Hkv": Hkv,
            "dh": dh, "G": H // Hkv, "splits": num_splits(B, Hkv, S, H // Hkv),
            **times,
            "library": "scaled_dot_product_attention(enable_gqa=True, "
                       "bool length mask)",
            "bytes": n_bytes, "operations": n_ops, "bound_ms": bound_ms,
            "bound_by": bound_by, "sets": len(sets)}


def _mc_case(torch, gen, dev, B, S, D, kind, dtype=None):
    """(tokens [B,S,D], mask [B,S] bool, K): ``kind`` "keep72" keeps a
    random 72% of the rows with K = S (the §VI payload), "all" keeps every
    row with K = S (the lossless KV hop), "make_mask" keeps the top 72% by
    row norm with K = round(0.72 S) (the lossy KV hop)."""
    from repro_torch.core.masking import make_mask, norm_scores
    from repro_torch.launch.serve import KEEP_RATE as KEEP
    dtype = dtype or torch.bfloat16
    if dtype.is_floating_point:
        toks = torch.randn((B, S, D), generator=gen, device=dev).to(dtype)
    else:
        toks = torch.randint(0, 128, (B, S, D), generator=gen, device=dev).to(dtype)
    if kind == "all":
        return toks, torch.ones((B, S), dtype=torch.bool, device=dev), S
    if kind == "make_mask":
        return toks, make_mask(norm_scores(toks), KEEP), max(1, round(KEEP * S))
    return toks, torch.rand((B, S), generator=gen, device=dev) < KEEP, S


def _time_masked_compact(torch, dev, gen, gname, B, S, D, kind):
    """masked_compact and its plain version on bf16 [B,S,D] inputs of
    ``kind`` (see ``_mc_case``), beside the bytes bound; where the wrapper
    takes a plan, the device time of each base-finding branch (short rows:
    every block counts the mask before its tile; long rows: a count pass
    into a workspace first) is timed too."""
    from repro_torch.core.profiler import H100_HBM_BW
    from repro_torch.kernels import masked_compact as mc
    from repro_torch.kernels import ref

    esize = 2
    sets = [_mc_case(torch, gen, dev, B, S, D, kind)
            for _ in range(_sets_for(B * S * D * esize))]
    fns = {"": lambda *a: mc.masked_compact_cuda(*a),
           "plain_": lambda *a: ref.masked_compact_ref(*a)}
    times = {f"{p}ms": _time_ms(torch, fn, sets) for p, fn in fns.items()}
    times.update({f"{p}device_ms": _device_ms(torch, fn, sets, iters=50 if not p else 20,
                                              need_ahead=not p)
                  for p, fn in fns.items()})
    K = sets[0][2]
    plan = None
    if hasattr(mc, "masked_compact_plan"):
        plan = mc.masked_compact_plan(B, S, D * esize, K)
        for branch in (False, True):
            forced = mc.masked_compact_plan(B, S, D * esize, K, long_rows=branch)
            times[f"device_ms_{'long' if branch else 'short'}_rows"] = _device_ms(
                torch, lambda *a: mc.masked_compact_cuda(*a, plan=forced), sets, iters=50)
        plan = dataclasses.asdict(plan)
    kept = int(torch.clamp(sets[0][1].sum(dim=1), max=K).sum())
    n_bytes = (B * S                               # mask
               + kept * D * esize                  # kept rows read
               + B * K * D * esize                 # out written
               + B * K * 4 + B * 4)                # idx, count
    return {"kernel": "masked_compact", "group": gname, "B": B, "S": S, "D": D,
            "K": K, "dtype": "bfloat16", "mask": kind, "kept_rows": kept,
            "plan": plan, **times, "library_ms": None,
            "library": "none: no single PyTorch call compacts rows",
            "bytes": n_bytes, "operations": 0,
            "bound_ms": 1e3 * n_bytes / H100_HBM_BW, "bound_by": "bytes",
            "share_of_bound": 1e3 * n_bytes / H100_HBM_BW / times["device_ms"],
            "sets": len(sets)}


def phase_timing(torch, dev, slice_summary):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    groups = dict(zip(slice_summary["group_names"], slice_summary["n_group"]))
    rows = [_time_decode_attention(torch, dev, gen, gname, B, 32, 8, 64)
            for gname, B in groups.items() if B]

    B = groups.get("auxiliary") or max(groups.values())
    rows.append(_time_masked_compact(torch, dev, gen, "auxiliary", B,
                                     PROMPT_LEN, 2048, "keep72"))
    for gname, kind in (("kv_hop_lossless", "all"), ("kv_hop_lossy", "make_mask")):
        rows.append(_time_masked_compact(torch, dev, gen, gname, *KV_HOP, kind))
    for row in rows:
        emit({"phase": "timing", **row})
    return rows


# ---------------------------------------------------------------------------
# The MoE path: moonshot-v1-16b-a3b
# ---------------------------------------------------------------------------
def _ffn_case(torch, gen, E, C, D, F, dtype, dev):
    """buf ~ N(0, 1), like the normed activations the MoE layer scatters,
    and expert weights at moe_init's scales."""
    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
    return (normal((E, C, D), 1.0), normal((E, D, F), D ** -0.5),
            normal((E, D, F), D ** -0.5), normal((E, F, D), F ** -0.5))


def _ffn_counts(torch, gen, kind, E, C, dev):
    """counts [E] int32: None, all zero, all C, or ragged in [0, C] with an
    expert at 0 (its buf rows stay non-zero: its output must be 0 all the
    same), one at C and one at 1."""
    if kind is None:
        return None
    if kind == "zero":
        return torch.zeros((E,), dtype=torch.int32, device=dev)
    if kind == "full":
        return torch.full((E,), C, dtype=torch.int32, device=dev)
    c = torch.randint(0, C + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    c[0], c[-1] = 0, C
    if E > 2:
        c[1] = 1
    return c


def phase_moe_kernel_checks(torch, dev, cfg, slice_summary):
    """grouped_ffn against its plain version at every capacity the slice
    ran, at edge cases and with counts (0, C, ragged: rows at or past a
    count are exactly 0, though buf's rows there are not), twice each,
    bit-equal; decode_attention's checks at moonshot's head shape (G=1,
    dh=128).  Returns the largest main-path error of each kernel (bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_ffn import grouped_ffn_cuda, tensor_core_path
    from repro_torch.models.moe import _capacity

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    bs = _batch_sizes(slice_summary)
    caps = sorted({_capacity(n * PROMPT_LEN, cfg) for n in bs}      # prefill
                  | {_capacity(n, cfg) for n in bs})                # decode
    cases = [("main-path", E, C, D, F, None) for C in caps]
    cases += [("ragged", 3, 1, 72, 88, None), ("ragged", 3, 13, 72, 88, None),
              ("ragged", 3, 1, 80, 88, None), ("ragged", 3, 13, 80, 88, None),
              ("ragged-scalar-loads", 2, 13, 70, 13, None),
              ("zero-rows", 8, 16, D, F, None), ("all-empty", E, caps[0], D, F, None),
              ("counts-zero", E, caps[0], D, F, "zero"),
              ("counts-full", E, caps[-1], D, F, "full"),
              ("counts-ragged", E, caps[0], D, F, "ragged"),
              ("counts-ragged", E, caps[-1], D, F, "ragged"),
              ("counts-ragged", 3, 13, 72, 88, "ragged"),
              ("counts-ragged", 4, 300, 64, 136, "ragged"),
              ("counts-ragged-scalar-loads", 2, 13, 70, 13, "ragged")]
    results, ffn_err = [], 0.0
    for name, e, C, d, f, kind in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            buf, wg, wu, wd = _ffn_case(torch, gen, e, C, d, f, dtype, dev)
            if name == "zero-rows":
                buf[:, 5:] = 0          # empty capacity slots
                buf[2] = 0              # an expert that received no row
            elif name == "all-empty":
                buf.zero_()
            counts = _ffn_counts(torch, gen, kind, e, C, dev)
            got = grouped_ffn_cuda(buf, wg, wu, wd, counts)
            again = grouped_ffn_cuda(buf, wg, wu, wd, counts)
            want = ref.grouped_ffn_ref(buf, wg, wu, wd, counts)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tag = f"grouped_ffn {name} E={e} C={C} D={d} F={f} {dname}"
            require(got.dtype == dtype and got.shape == buf.shape
                    and bool(torch.isfinite(got).all()), f"{tag}: bad output")
            require(err <= FFN_TOL[dname],
                    f"{tag}: max_abs_err {err} > {FFN_TOL[dname]}")
            require(torch.equal(got, again), f"{tag}: two calls differ")
            row = {"case": name, "E": e, "C": C, "D": d, "F": f, "dtype": dname,
                   "path": "tensor_cores" if tensor_core_path(dtype, d, f)
                   else "cuda_cores", "max_abs_err": err,
                   "out_mean_abs": float(got.float().abs().mean()),
                   "bit_equal_twice": True}
            empty = (buf == 0).all(dim=-1)
            if counts is not None:
                empty |= torch.arange(C, device=dev)[None, :] >= counts[:, None]
                row["counts"] = counts.tolist()[:8]
            if bool(empty.any()):
                exact = bool((got[empty] == 0).all())
                require(exact, f"{tag}: zero rows or rows past the count gave "
                        "non-zero rows")
                row["zero_rows"] = int(empty.sum())
                row["zero_rows_exact"] = exact
            if name == "main-path" and dtype == torch.bfloat16:
                ffn_err = max(ffn_err, err)
            results.append(row)
            del buf, wg, wu, wd, got, again, want
    emit({"phase": "moe_kernels", "kernel": "grouped_ffn", "tolerance": FFN_TOL,
          "cases": results})

    att_err = _check_decode_attention(torch, dev, gen, bs, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      "moe_kernels")
    return {"grouped_ffn": ffn_err, "decode_attention": att_err}


def phase_moe_parity(torch, dev, cfg, params, prompts):
    """A 2-layer float32 cut of the slice's weights at full width: kernel
    path against plain path over 8 teacher-forced decode steps, with the
    router's top-k margins recorded; then macro_steps 8 and 0 at full depth
    in bf16 give identical streams."""
    from repro_torch.core.offload import tree_map
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import (make_prefill_step, make_serve_step,
                                            seed_cache)

    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p32 = {k: tree_map(lambda t: t.float(), v) for k, v in params.items()
           if k != "blocks"}
    p32["blocks"] = tree_map(lambda t: t[:2].float(), params["blocks"])
    B, K = 4, cfg.experts_per_token
    tokens = torch.as_tensor(prompts[:B], device=dev)
    log = []                         # (sorted expert ids [T,K], min margin)
    orig = moe_mod.moe_apply

    def spy(p, x, c, **kw):          # records each MoE call's routing
        _, ids, _, probs = moe_mod.route(x.reshape(-1, x.shape[-1]), p["router"], c)
        top = torch.topk(probs, K + 1, dim=-1).values
        log.append((ids.sort(dim=-1).values, float((top[:, -2] - top[:, -1]).min())))
        return orig(p, x, c, **kw)

    errs, margins, flips = [], [], []
    with torch.no_grad():
        last, pre = make_prefill_step(cfg2, use_kernels=False)(p32, {"tokens": tokens})
        caches = [seed_cache(cfg2, M.init_cache(cfg2, B, S_MAIN, device=dev),
                             pre, PROMPT_LEN) for _ in range(2)]
        del pre
        plain = make_serve_step(cfg2, use_kernels=False)
        kern = make_serve_step(cfg2, use_kernels=True)
        tok = last.argmax(dim=-1).to(torch.int32)
        moe_mod.moe_apply = spy
        try:
            for i in range(8):
                lengths = torch.full((B,), PROMPT_LEN + i, dtype=torch.int32,
                                     device=dev)
                log.clear()
                lp, _ = plain(p32, caches[0], tok[:, None], lengths)
                plain_log = list(log)
                log.clear()
                lk, _ = kern(p32, caches[1], tok[:, None], lengths)
                errs.append(float((lk - lp).abs().max()))
                margins += [m for _, m in plain_log + log]
                flips += [{"step": i, "layer": j, "margin": min(a[1], b[1])}
                          for j, (a, b) in enumerate(zip(plain_log, log))
                          if not torch.equal(a[0], b[0])]
                tok = lp.argmax(dim=-1).to(torch.int32)
        finally:
            moe_mod.moe_apply = orig
        del caches, p32
    for i, err in enumerate(errs):
        excused = any(f["step"] <= i and f["margin"] < 1e-6 for f in flips)
        require(err <= 1e-3 or excused,
                f"MoE teacher-forced step {i}: logits differ by {err} > 1e-3 "
                f"between kernel and plain paths with no routing flip at a "
                f"margin below 1e-6 (flips: {flips})")

    same = _macro_streams_equal(torch, dev, cfg, params, prompts[:B], MAX_NEW)
    emit({"phase": "moe_parity", "arch": cfg.name, "layers": 2,
          "dtype": "float32", "requests": B, "teacher_forced_max_abs": errs,
          "tolerance": 1e-3, "min_router_margin": min(margins),
          "routing_flips": flips, "macro_8_equals_0": same,
          "macro_check_dtype": "bfloat16", "macro_check_layers": cfg.num_layers})


def _routed_buffer(torch, moe_mod, cfg, router, T, C, gen, dev, dtype):
    """(buf [E,C,D] in dtype, counts [E] int32): T random tokens (unit normal,
    like the normed activations the layer routes) through a layer's real
    router and moe_apply's dispatch, so the rows and experts in use are the
    ones such a batch routes."""
    E, D = cfg.num_experts, cfg.d_model
    xt = torch.randn((T, D), generator=gen, device=dev).to(dtype)
    _, ids, _, _ = moe_mod.route(xt, router, cfg)
    _, sorted_ids, pos, keep, src, counts = moe_mod.dispatch(ids, E, C)
    buf = torch.zeros((E, C, D), dtype=dtype, device=dev)
    buf.index_put_((sorted_ids, torch.where(keep, pos, 0)),
                   xt[src].masked_fill(~keep[:, None], 0), accumulate=True)
    return buf, counts.clamp(max=C).to(torch.int32)


def phase_moe_timing(torch, dev, cfg, params, slice_summary):
    """grouped_ffn at decode (B tokens) and at the auxiliary group's prefill
    (B x 128 tokens), each layer's buffer and counts made by routing random
    tokens through that layer's router, cycling through the slice's 48
    layers (1.1 GB of experts a layer, far past L2).  Beside the kernel:
    its plain version and the bf16 composition of three torch.bmm calls and
    silu*mul over every row; two bounds, one over every expert's weights
    and one over the experts and rows these inputs route (``bound_ms``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_ffn import grouped_ffn_cuda
    from repro_torch.models import moe as moe_mod

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    experts = params["blocks"]["moe"]
    groups = dict(zip(slice_summary["group_names"], slice_summary["n_group"]))
    B = groups.get("auxiliary") or max(groups.values())

    def composition(buf, wg, wu, wd, counts=None):
        return torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)

    rows = []
    for step, T in (("decode", B), ("prefill", B * PROMPT_LEN)):
        C = moe_mod._capacity(T, cfg)
        sets = []
        with torch.no_grad():
            for i in range(cfg.num_layers):
                buf, counts = _routed_buffer(torch, moe_mod, cfg,
                                             experts["router"][i], T, C, gen, dev,
                                             experts["w_gate"].dtype)
                sets.append((buf, experts["w_gate"][i], experts["w_up"][i],
                             experts["w_down"][i], counts))
        got, want = grouped_ffn_cuda(*sets[0]), ref.grouped_ffn_ref(*sets[0])
        err = float((got.float() - want.float()).abs().max())
        require(err <= FFN_TOL["bfloat16"], f"grouped_ffn {step} on routed "
                f"buffers: max_abs_err {err} > {FFN_TOL['bfloat16']}")
        comp_err = float((composition(*sets[0]).float() - want.float()).abs().max())
        used = sum(int((c > 0).sum()) for *_, c in sets) / len(sets)
        routed_rows = sum(int(c.sum()) for *_, c in sets) / len(sets)
        fns = {"": grouped_ffn_cuda, "plain_": ref.grouped_ffn_ref,
               "composition_": composition}
        times = {f"{p}ms": _time_ms(torch, fn, sets, iters=96, warmup=4)
                 for p, fn in fns.items()}
        iters = {"": 48, "plain_": 12, "composition_": 48}
        times.update({f"{p}device_ms": _device_ms(torch, fn, sets, iters=iters[p],
                                                  need_ahead=not p)
                      for p, fn in fns.items()})
        w_bytes = 3 * D * Fd * 2                          # one expert, bf16
        all_bytes = 2 * (2 * E * C * D) + E * w_bytes     # buf, out, every expert
        all_ms, all_by = _bound(all_bytes, 6 * E * C * D * Fd)
        n_bytes = (2 * routed_rows * D + 2 * E * C * D    # routed rows read, out
                   + used * w_bytes + 4 * E)              # routed experts, counts
        n_ops = 6 * routed_rows * D * Fd                  # three products
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        rows.append({"kernel": "grouped_ffn", "step": step, "group": "auxiliary",
                     "B": B, "tokens": T, "E": E, "C": C, "D": D, "F": Fd,
                     "dtype": "bfloat16", "experts_used_mean": used,
                     "routed_rows_mean": routed_rows, "max_abs_err": err, **times,
                     "library_ms": None,
                     "library": "none: no single PyTorch call computes this function",
                     "composition": "torch.bmm x3 + silu*mul over all rows, bf16",
                     "composition_max_abs_err": comp_err,
                     "bytes": n_bytes, "operations": n_ops, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_counts": "routed experts and rows",
                     "bound_all_experts_ms": all_ms, "bound_all_experts_by": all_by,
                     "sets": len(sets)})
        del sets, got, want
    rows.append(_time_decode_attention(torch, dev, gen, "auxiliary", B,
                                       cfg.num_heads, cfg.num_kv_heads,
                                       cfg.head_dim))
    for row in rows:
        emit({"phase": "moe_timing", "arch": cfg.name, **row})
    return rows


def phase_long_cache_timing(torch, dev, B, heads):
    """decode_attention, its plain version and SDPA at a long full cache,
    while no model's weights are held: ``heads`` maps a config's name to
    (H, Hkv, dh, cache length)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows = []
    for arch, (H, Hkv, dh, S) in heads.items():
        row = _time_decode_attention(torch, dev, gen, "long-cache", B, H, Hkv,
                                     dh, S=S, cache_len=S)
        row["heads_of"] = arch
        rows.append(row)
        emit({"phase": "long_cache_timing", **row,
              "share_of_bound": row["bound_ms"] / row["device_ms"]})
    return rows


# ---------------------------------------------------------------------------
# The SSM path: falcon-mamba-7b; then the hybrid zamba2-2.7b
# ---------------------------------------------------------------------------
def _scan_case(torch, gen, B, S, di, N, dev, pure_decay=False):
    """decay in [0.5, 0.999), bx ~ N(0, 0.1^2), h0 ~ N(0, 1) (the JAX
    suite's draws); ``pure_decay``: decay 0.99, bx 0, h0 1."""
    if pure_decay:
        decay = torch.full((B, S, di, N), 0.99, device=dev)
        return decay, torch.zeros_like(decay), torch.ones((B, di, N), device=dev)
    decay = torch.rand((B, S, di, N), generator=gen, device=dev) * 0.499 + 0.5
    bx = torch.randn((B, S, di, N), generator=gen, device=dev) * 0.1
    return decay, bx, torch.randn((B, di, N), generator=gen, device=dev)


def phase_ssm_kernel_checks(torch, dev, cfg, slice_summary):
    """ssm_scan against its plain version at every (B, S, di, N) the slice
    ran, at ragged shapes (S 1 and 300, di 100 and 101, N 3: the float4 and
    the scalar path) and the pure-decay case, h0 non-zero, f32 within 1e-5
    of the largest |h| (both sum in the same order, so they should agree
    bit for bit).  Returns the largest main-path abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    di, N = cfg.d_inner, cfg.ssm_state
    cases = [("main-path", B, PROMPT_LEN, di, N) for B in _batch_sizes(slice_summary)]
    cases += [("ragged", 3, 1, 100, 3), ("ragged", 2, 300, 100, 3),
              ("ragged-scalar", 2, 300, 101, 3), ("pure-decay", 1, 128, 256, 8)]
    results, main_err = [], 0.0
    for name, B, S, d, n in cases:
        decay, bx, h0 = _scan_case(torch, gen, B, S, d, n, dev,
                                   pure_decay=name == "pure-decay")
        got = ssm_scan_cuda(decay, bx, h0)
        want = ref.ssm_scan_ref(decay, bx, h0)
        torch.cuda.synchronize()
        tag = f"ssm_scan {name} B={B} S={S} di={d} N={n}"
        require(all(g.shape == w.shape and g.dtype == torch.float32
                    and bool(torch.isfinite(g).all()) for g, w in zip(got, want)),
                f"{tag}: bad output")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = float(want[0].abs().max())
        require(err <= SCAN_TOL * max(scale, 1e-30),
                f"{tag}: max_abs_err {err} > {SCAN_TOL} x max|h| {scale}")
        row = {"case": name, "B": B, "S": S, "di": d, "N": n,
               "max_abs_err": err, "max_abs_h": scale,
               "exact": all(torch.equal(g, w) for g, w in zip(got, want))}
        if name == "pure-decay":
            decay_err = float((got[1] - 0.99 ** S).abs().max())
            require(decay_err <= 1e-3 * 0.99 ** S,
                    f"{tag}: h_last differs from 0.99^S by {decay_err}")
            row["pure_decay_err"] = decay_err
        if name == "main-path":
            main_err = max(main_err, err)
        results.append(row)
        del decay, bx, h0, got, want
    emit({"phase": "ssm_kernels", "kernel": "ssm_scan", "dtype": "float32",
          "tolerance": f"{SCAN_TOL} x max|h|", "cases": results})
    return {"ssm_scan": main_err}


def phase_ssm_parity(torch, dev, cfg, params, prompts):
    """A 2-layer float32 cut of the slice's weights at full width: the
    kernel path against the plain path, prefill logits and states and 8
    teacher-forced decode steps' logits within 1e-3 (the prefill states
    come from ssm_scan or its plain version; decode steps them with
    mamba1_step on both paths); then macro_steps 8 and 0 at full depth in
    bf16 give identical streams."""
    from repro_torch.core.offload import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import (make_prefill_step, make_serve_step,
                                            seed_cache)

    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p32 = {k: tree_map(lambda t: t.float(), v) for k, v in params.items()
           if k != "blocks"}
    p32["blocks"] = tree_map(lambda t: t[:2].float(), params["blocks"])
    B = 4
    tokens = torch.as_tensor(prompts[:B], device=dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        lk, pre_k = make_prefill_step(cfg2, use_kernels=True)(p32, {"tokens": tokens})
        launched = ops.launch_counts()["ssm_scan"]
        lp, pre_p = make_prefill_step(cfg2, use_kernels=False)(p32, {"tokens": tokens})
        require(launched == 2 and ops.launch_counts()["ssm_scan"] == 2,
                f"the kernel prefill launched ssm_scan {launched} times, the "
                "plain one must launch none (2-layer cut: expected 2)")
        errs = [float((lk - lp).abs().max())]
        state_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(pre_k, pre_p))
        caches = [seed_cache(cfg2, M.init_cache(cfg2, B, S_MAIN, device=dev),
                             pre, PROMPT_LEN) for pre in (pre_p, pre_k)]
        del pre_k, pre_p
        plain = make_serve_step(cfg2, use_kernels=False)
        kern = make_serve_step(cfg2, use_kernels=True)
        tok = lp.argmax(dim=-1).to(torch.int32)
        for i in range(8):
            lengths = torch.full((B,), PROMPT_LEN + i, dtype=torch.int32, device=dev)
            lp, _ = plain(p32, caches[0], tok[:, None], lengths)
            lk, _ = kern(p32, caches[1], tok[:, None], lengths)
            errs.append(float((lk - lp).abs().max()))
            tok = lp.argmax(dim=-1).to(torch.int32)
        del caches, p32
    require(max(errs) <= 1e-3 and state_err <= 1e-3,
            f"{cfg.name}: kernel and plain paths differ: logits {errs}, "
            f"prefill states {state_err} (tolerance 1e-3)")
    same = _macro_streams_equal(torch, dev, cfg, params, prompts[:B], MAX_NEW)
    emit({"phase": "ssm_parity", "arch": cfg.name, "layers": 2,
          "dtype": "float32", "requests": B,
          "prefill_and_teacher_forced_max_abs": errs,
          "prefill_state_max_abs": state_err, "tolerance": 1e-3,
          "macro_8_equals_0": same, "macro_check_dtype": "bfloat16",
          "macro_check_layers": cfg.num_layers})


def phase_ssm_timing(torch, dev, cfg, slice_summary):
    """ssm_scan and its plain version at the auxiliary group's prefill
    shape (B=11: [11,128,8192,16] f32, 1.48 GB of inputs a call), cycling
    through more input sets than L2 holds; ``device_ms`` from ``_device_ms``
    (the plain version's 384 launches a call allow one call a loop)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    groups = dict(zip(slice_summary["group_names"], slice_summary["n_group"]))
    B = groups.get("auxiliary") or max(groups.values())
    S, di, N = PROMPT_LEN, cfg.d_inner, cfg.ssm_state
    C = di * N
    sets = [_scan_case(torch, gen, B, S, di, N, dev)
            for _ in range(_sets_for(4 * B * C * (2 * S + 1)))]
    fns = {"": ssm_scan_cuda, "plain_": ref.ssm_scan_ref}
    times = {f"{p}ms": _time_ms(torch, fn, sets, iters=40, warmup=4)
             for p, fn in fns.items()}
    times["device_ms"] = _device_ms(torch, ssm_scan_cuda, sets, iters=10)
    times["plain_device_ms"] = _device_ms(torch, ref.ssm_scan_ref, sets, iters=1,
                                          need_ahead=False)
    n_bytes = 4 * B * C * (3 * S + 2)     # decay, bx, h_all; h0, h_last (f32)
    n_ops = 2 * B * S * C                 # a multiply and an add per element
    bound_ms, bound_by = _bound(n_bytes, n_ops, H100_PEAK_FLOPS_F32)
    row = {"kernel": "ssm_scan", "step": "prefill", "group": "auxiliary",
           "B": B, "S": S, "di": di, "N": N, "dtype": "float32", **times,
           "library_ms": None,
           "library": "none: no single PyTorch call computes this recurrence",
           "bytes": n_bytes, "operations": n_ops, "bound_ms": bound_ms,
           "bound_by": bound_by, "sets": len(sets)}
    emit({"phase": "ssm_timing", "arch": cfg.name, **row})
    return [row]


def phase_hybrid(torch, dev):
    """zamba2-2.7b at full width through the launcher (--split none), its
    decode_attention launches held to 9 shared-block calls a decode step;
    decode_attention against its plain version at zamba2's head shape
    (H=Hkv=32, dh=80); macro_steps 8 and 0 give identical bf16 streams.
    Returns (launch counts, {kernel: main-path error})."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(HYBRID_ARCH)
    summary, counts = phase_slice(torch, HYBRID_ARCH, phase="hybrid_slice",
                                  split="none", requests=HYBRID_REQUESTS,
                                  max_new=HYBRID_MAX_NEW)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    err = _check_decode_attention(torch, dev, gen, [HYBRID_REQUESTS],
                                  cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                  "hybrid_kernels")
    params = M.init_params(cfg, 0, device=dev)          # the slice's weights
    prompts = _prompts(cfg)[:HYBRID_REQUESTS]
    same = _macro_streams_equal(torch, dev, cfg, params, prompts, HYBRID_MAX_NEW)
    emit({"phase": "hybrid_parity", "arch": cfg.name, "requests": HYBRID_REQUESTS,
          "macro_8_equals_0": same, "dtype": "bfloat16",
          "layers": cfg.num_layers})
    del params
    return counts, {"decode_attention": err}


# ---------------------------------------------------------------------------
KERNEL_META = {
    "decode_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:75"},
    "masked_compact": {
        "route": "cuda", "source": "src/repro_torch/csrc/masked_compact.cu",
        "replaces": "src/repro/kernels/masked_compact.py:70"},
    "grouped_ffn": {
        "route": "cuda", "source": "src/repro_torch/csrc/grouped_ffn.cu",
        "replaces": "src/repro/kernels/grouped_ffn.py:47"},
    "ssm_scan": {
        "route": "cuda", "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:51"},
}


def kernels_line(rows, counts_by_path, errs):
    """One entry per kernel: decode_attention and masked_compact timed at
    llama's auxiliary group, grouped_ffn at moonshot's auxiliary group's
    decode, ssm_scan at falcon-mamba's auxiliary group's prefill; launches
    summed over every main path (and listed per path); max_abs_err the
    largest main-path error of any path."""
    pick = {}           # each kernel's first row timed at an auxiliary group
    for row in rows:
        if row["group"] == "auxiliary":
            pick.setdefault(row["kernel"], row)
    kernels = []
    for kname, meta in KERNEL_META.items():
        row = pick[kname]
        by_path = {arch: c[kname] for arch, c in counts_by_path.items()}
        entry = {"name": kname, **meta, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(e.get(kname, 0.0) for e in errs),
                 "ms": row["ms"], "device_ms": row["device_ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for key in ("composition_ms", "bound_counts", "bound_all_experts_ms"):
            if key in row:
                entry[key] = row[key]
        kernels.append(entry)
    return kernels


def timed(label, fn, *args, **kw):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase": "seconds", "of": label, "seconds": time.perf_counter() - t0})
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's package is not next to this script ({SRC / 'repro_torch'})")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    name, card = phase_env(torch)
    timed("build", phase_build)
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    # the dense path: llama3.2-1b
    slice_summary, counts = timed("slice", phase_slice, torch)
    errs = timed("kernels", phase_kernel_checks, torch, dev, slice_summary)
    cfg, params, prompts = timed("parity", phase_parity, torch, dev)
    groups = dict(zip(slice_summary["group_names"], slice_summary["n_group"]))
    timed("trace", phase_trace, torch, dev, cfg, params, prompts,
          groups["auxiliary"] or REQUESTS)
    del params
    rows = timed("timing", phase_timing, torch, dev, slice_summary)
    torch.cuda.empty_cache()

    # the MoE path: moonshot-v1-16b-a3b at full width
    moe_cfg = get_config(MOE_ARCH)
    moe_summary, moe_counts = timed("moe_slice", phase_slice, torch, MOE_ARCH)
    moe_errs = timed("moe_kernels", phase_moe_kernel_checks, torch, dev,
                     moe_cfg, moe_summary)
    torch.cuda.empty_cache()
    params = M.init_params(moe_cfg, 0, device=dev)      # the slice's weights
    prompts = _prompts(moe_cfg)
    timed("moe_parity", phase_moe_parity, torch, dev, moe_cfg, params, prompts)
    groups = dict(zip(moe_summary["group_names"], moe_summary["n_group"]))
    timed("moe_trace", phase_trace, torch, dev, moe_cfg, params, prompts,
          groups["auxiliary"] or REQUESTS, max_new=MOE_TRACE_NEW)
    moe_rows = timed("moe_timing", phase_moe_timing, torch, dev, moe_cfg,
                     params, moe_summary)
    del params
    torch.cuda.empty_cache()
    # decode_attention at long caches, no weights held: llama's and moonshot's heads
    long_rows = timed("long_cache_timing", phase_long_cache_timing, torch, dev,
                      groups["auxiliary"] or REQUESTS,
                      {ARCH: (32, 8, 64, 32768),
                       MOE_ARCH: (moe_cfg.num_heads, moe_cfg.num_kv_heads,
                                  moe_cfg.head_dim, 8192)})
    torch.cuda.empty_cache()

    # the SSM path: falcon-mamba-7b at full width
    ssm_cfg = get_config(SSM_ARCH)
    ssm_summary, ssm_counts = timed("ssm_slice", phase_slice, torch, SSM_ARCH,
                                    phase="ssm_slice")
    ssm_errs = timed("ssm_kernels", phase_ssm_kernel_checks, torch, dev,
                     ssm_cfg, ssm_summary)
    torch.cuda.empty_cache()
    params = M.init_params(ssm_cfg, 0, device=dev)      # the slice's weights
    prompts = _prompts(ssm_cfg)
    timed("ssm_parity", phase_ssm_parity, torch, dev, ssm_cfg, params, prompts)
    groups = dict(zip(ssm_summary["group_names"], ssm_summary["n_group"]))
    timed("ssm_trace", phase_trace, torch, dev, ssm_cfg, params, prompts,
          groups["auxiliary"] or REQUESTS)
    del params
    torch.cuda.empty_cache()
    ssm_rows = timed("ssm_timing", phase_ssm_timing, torch, dev, ssm_cfg,
                     ssm_summary)
    torch.cuda.empty_cache()

    # the hybrid path: zamba2-2.7b at full width, decode_attention at dh=80
    hyb_counts, hyb_errs = timed("hybrid", phase_hybrid, torch, dev)

    kernels = kernels_line(
        rows + moe_rows + ssm_rows + long_rows,
        {ARCH: counts, MOE_ARCH: moe_counts, SSM_ARCH: ssm_counts,
         HYBRID_ARCH: hyb_counts},
        [errs, moe_errs, ssm_errs, hyb_errs])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
