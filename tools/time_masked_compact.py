#!/usr/bin/env python3
"""Time the masked_compact kernel of a repro_torch tree on one CUDA card.

    python3 tools/time_masked_compact.py [--src DIR] [--sweep]

Imports the ``repro_torch`` package found under DIR (default: this
checkout's ``src``), builds its kernels (into DIR's own ``../build``), and
times ``masked_compact_cuda`` and its plain version with ``chip_smoke.py``'s
helpers at the §VI payload's shape (bf16 [11,128,2048], K=128, 72% kept)
and at llama3.2-1b's prefill->decode KV hop ([16,2048,512], lossless and
top-72%).  Each result is checked bit for bit against the plain version
first.  Where the tree's wrapper takes a plan, it also runs chip_smoke.py's
masked_compact checks first, times longer lossless rows ([16,4096,512],
[16,8192,512], [4,32768,512], [2,32768,64], and [1,131072,64], where the
plan takes the count pass) and, with --sweep, every tile and chunk
count of both base-finding branches at each shape.  Last, one block's
call ([1,1,8], K=1) gives the launch's device floor and the wrapper's host
cost.  Prints one JSON line per shape, sweep and floor, each with the
card's nvidia-smi line.
To compare two trees, run it in turns on one card, in one command:
``--src old/src``, ``--src src``, ``--src src``, ``--src old/src``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN_B = 11        # the §VI payload's batch: the auxiliary group of 16 requests


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch package")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every tile x chunk count x branch")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this timing needs a CUDA card")
    import repro_torch
    cs.require(Path(repro_torch.__file__).resolve().is_relative_to(src),
               f"repro_torch imported from {repro_torch.__file__}, not {src}")
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import masked_compact as mc

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_env(torch)
    cs.emit({"phase": "build", "library": _build.load()._name,
             "nvcc_seconds": _build.build_info.get("seconds")})
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    shapes = [("auxiliary", (MAIN_B, cs.PROMPT_LEN, 2048), "keep72"),
              ("kv_hop_lossless", cs.KV_HOP, "all"),
              ("kv_hop_lossy", cs.KV_HOP, "make_mask")]
    planned = hasattr(mc, "masked_compact_plan")
    if planned:
        cs._check_masked_compact(torch, dev, gen, MAIN_B)
        shapes += [(f"long_rows_{S}", (B, S, 512), "all")
                   for B, S in ((16, 4096), (16, 8192), (4, 32768))]
        shapes += [("long_narrow_rows_32768", (2, 32768, 64), "all"),
                   ("long_narrow_rows_131072", (1, 131072, 64), "all")]
    for gname, shape, kind in shapes:
        toks, mask, K = cs._mc_case(torch, gen, dev, *shape, kind)
        got = mc.masked_compact_cuda(toks, mask, K)
        want = ref.masked_compact_ref(toks, mask, K)
        cs.require(all(torch.equal(a, b) for a, b in zip(got, want)),
                   f"masked_compact {gname}: differs from the plain version")
        del toks, mask, got, want
        row = cs._time_masked_compact(torch, dev, gen, gname, *shape, kind)
        cs.emit({"phase": "masked_compact_timing", "src": str(src), **row})
        if planned and args.sweep:
            cs.emit({"phase": "masked_compact_plans", "group": gname,
                     "device_ms": _sweep(torch, cs, mc, gen, dev, shape, kind)})
        torch.cuda.empty_cache()
    # one block's call ([1,1,8], K=1): the launch's device floor, and the
    # wrapper's host cost per call (its ms, the device being idle)
    sets = [cs._mc_case(torch, gen, dev, 1, 1, 8, "all")]
    cs.emit({"phase": "masked_compact_floor", "src": str(src), "B": 1, "S": 1,
             "D": 8, "K": 1,
             "ms": cs._time_ms(torch, mc.masked_compact_cuda, sets, iters=1000),
             "device_ms": cs._device_ms(torch, mc.masked_compact_cuda, sets, iters=200)})
    if args.sweep:
        cs.emit({"phase": "masked_compact_alloc_host_us", **_alloc_host_us(torch, dev)})


def _alloc_host_us(torch, dev, B=11, K=128, D=2048, n=5000):
    """Host microseconds a call of the wrapper's output allocation: three
    torch.empty calls, against out plus one int32 buffer cut into idx and
    count (two views)."""
    import time

    def three():
        torch.empty((B, K, D), dtype=torch.bfloat16, device=dev)
        torch.empty((B, K), dtype=torch.int32, device=dev)
        torch.empty((B,), dtype=torch.int32, device=dev)

    def cut():
        torch.empty((B, K, D), dtype=torch.bfloat16, device=dev)
        ints = torch.empty((B * K + B,), dtype=torch.int32, device=dev)
        ints[:B * K].view(B, K), ints[B * K:]

    out = {}
    for name, fn in (("three_empty", three), ("one_int32_cut", cut)) * 2:
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.setdefault(name, []).append(1e6 * (time.perf_counter() - t0) / n)
    return out


def _sweep(torch, cs, mc, gen, dev, shape, kind):
    """Device ms of every tile (32-256) x chunk count (1-8) x base-finding
    branch at one shape, keyed "T<tile>_c<chunks>_<short|long>"."""
    B, S, D = shape
    sets = [cs._mc_case(torch, gen, dev, B, S, D, kind)
            for _ in range(cs._sets_for(B * S * D * 2))]
    K = sets[0][2]
    out = {}
    for tile in (32, 64, 128, 256):
        for chunks in (1, 2, 4, 8):
            for long_rows in (False, True):
                plan = mc.make_plan(B, S, K, tile, chunks, long_rows)
                out[f"T{tile}_c{chunks}_{'long' if long_rows else 'short'}"] = \
                    cs._device_ms(torch, lambda *a: mc.masked_compact_cuda(*a, plan=plan),
                                  sets, iters=30)
    return out


if __name__ == "__main__":
    main()
