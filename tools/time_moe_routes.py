#!/usr/bin/env python3
"""Time a dropless MoE layer's two routes on one CUDA card, by tokens.

    python3 tools/time_moe_routes.py [--tokens 64 128 ...] [--layers 4]

At moonlight-16b-a3b's MoE width (64 experts of 1,408, top-6, D 2,048,
bf16, the port's own weight draw for ``--layers`` layers, cycled so that
every call finds its experts cold in L2), for each token count T: one
``models/moe.py:moe_apply`` (router, routed experts, shared experts) on
the capacity route (``[E, C, D]`` buffers in chunks of ``DROPLESS_TOKENS``)
and on the sorted route (``grouped_ffn_sorted`` over the T·K sorted rows),
each forced by standing in ``moe.sorted_route``.  Per route: ``ms``, what a
caller pays a call (CUDA events around a loop: the host's enqueueing where
it is the slower) and ``device_ms`` (the device work alone, back to back,
over at most 12 calls held behind a device-side sleep; None where the host
never got ahead of the device), and the largest gap between the two
routes' outputs.  ``SORTED_ROWS_PER_EXPERT`` in ``models/moe.py`` is read
from these rows (PERF.md).  Prints one JSON line a token count, each with
the card's nvidia-smi line.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, nargs="+",
                    default=[16, 64, 128, 256, 512, 1024, 2048, 4096, 7168])
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_env(torch)
    cs.phase_build()
    cfg = get_config("moonlight-16b-a3b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    stacked = moe.moe_init(gen, cfg, torch.bfloat16, dev, args.layers)
    stacked["router_bias"].normal_(0.0, 0.1, generator=gen)
    layers = [{k: (v[i] if torch.is_tensor(v) else
                   {n: t[i] for n, t in v.items()})
               for k, v in stacked.items()} for i in range(args.layers)]
    real = moe.sorted_route
    try:
        for T in args.tokens:
            sets = [(torch.randn((1, T, cfg.d_model), generator=gen,
                                 device=dev).bfloat16(), p) for p in layers]
            row = {"tokens": T, "rows_per_expert":
                   T * cfg.experts_per_token / cfg.num_experts}
            outs = {}
            iters = max(4, min(48, 98304 // T))
            for name, take in (("capacity", False), ("sorted", True)):
                moe.sorted_route = lambda *a, _t=take: _t

                def fn(x, p):
                    return moe.moe_apply(p, x, cfg, use_kernels=True)[0]

                with torch.no_grad():
                    outs[name] = fn(*sets[0]).float()
                    row[f"{name}_ms"] = cs._time_ms(torch, fn, sets,
                                                    iters=iters, warmup=2)
                    row[f"{name}_device_ms"] = cs._device_ms(
                        torch, fn, sets, iters=min(iters, 12),
                        need_ahead=False)
            row["max_abs_gap"] = float((outs["sorted"] - outs["capacity"])
                                       .abs().max())
            row["max_abs_out"] = float(outs["capacity"].abs().max())
            cs.emit({"phase": "moe_routes", **row})
            del sets, outs
    finally:
        moe.sorted_route = real
    cs.emit({"phase": "done"})


if __name__ == "__main__":
    main()
