#!/usr/bin/env python3
"""Check and time the multi-head latent attention kernels on one CUDA card.

    python3 tools/check_mla_kernels.py [--src DIR] [--digest-only]

Imports the ``repro_torch`` package found under DIR (default: this
checkout's ``src``) and builds its kernels (into DIR's own ``../build``).
Then, at moonlight-16b-a3b's shapes (16 heads; latent rows of 512 + 64;
expanded heads of q/k 192 and v 128):

* ``mla_decode_attention`` and ``prefill_attention``'s q/k 192, v 128
  instance against their plain versions and timed, as ``chip_smoke.py``'s
  ``mla`` phase checks them (``phase_mla``), with more cases: the decode
  also at one split, fewer heads, an empty slot and an int length, the
  instance also at a ragged and a padded prompt;
* the head-width-128 instance at nemotron-4-15b's prefill (B=1, 2,048
  tokens, 48/8 heads): a digest of its bf16 output on seeded inputs and
  its device time.  ``--digest-only`` runs this alone, for a tree whose
  kernels predate the others; run it in turns on one card, in one command
  (``--src old/src``, ``--src src``), to compare two trees.

Prints one JSON line a phase, each with the card's nvidia-smi line; exits
non-zero on the first check that fails.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_prefill(torch, cs, dev, gen, B, S, heads, kv_heads, dk, dv,
                 digest: bool):
    """Device time of one causal prompt; with ``digest`` also the sha256 of
    the bf16 output on inputs seeded apart from ``gen``."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    pos = torch.arange(S, device=dev)
    kw = dict(causal=True, window=0, q_positions=pos, kv_positions=pos)
    widths = {} if dv == dk else {"dv": dv}     # an older tree has no dv
    cost = costs.prefill_attention(B, S, S, heads, kv_heads, dk, True, 0,
                                   **widths)
    shapes = ((B, S, heads, dk), (B, S, kv_heads, dk), (B, S, kv_heads, dv))
    row = {"phase": "timing", "kernel": "prefill_attention", "B": B, "S": S,
           "H": heads, "Hkv": kv_heads, "dh": dk, "dv": dv}
    if digest:
        g = torch.Generator(device=dev)
        g.manual_seed(2024)
        q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16()
                   for s in shapes)
        out = prefill_attention_cuda(q, k, v, **kw)
        row["digest"] = hashlib.sha256(
            out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    sets = [tuple(torch.randn(s, generator=gen, device=dev).bfloat16()
                  for s in shapes) for _ in range(cs._sets_for(cost["bytes"]))]

    def fn(q, k, v):
        return prefill_attention_cuda(q, k, v, **kw)
    dev_ms = cs._device_ms(torch, fn, sets, iters=30)
    bound_ms, bound_by = cs._bound(cost["bytes"], cost["flops"])
    row.update(ms=cs._time_ms(torch, fn, sets, iters=30, warmup=3),
               device_ms=dev_ms, operations=cost["flops"],
               bytes=cost["bytes"], bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / dev_ms,
               tflops=cost["flops"] / dev_ms / 1e9)
    cs.emit(row)
    del sets
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch package")
    ap.add_argument("--digest-only", action="store_true",
                    help="only the head-width-128 instance's digest and time")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: these checks need a "
                "CUDA card")
    import repro_torch
    cs.require(Path(repro_torch.__file__).resolve().is_relative_to(src),
               f"repro_torch imported from {repro_torch.__file__}, not {src}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_env(torch)
    cs.phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    time_prefill(torch, cs, dev, gen, 1, 2048, 48, 8, 128, 128, digest=True)
    if args.digest_only:
        return
    cs._check_mla_decode(torch, dev, gen, more=True)
    cs._check_mla_prefill(torch, dev, gen, more=True)
    for row in (cs._time_mla_decode(torch, dev, gen),
                cs._time_mla_prefill(torch, dev, gen)):
        cs.emit({"phase": "timing", **row})
    cs.emit({"phase": "done"})


if __name__ == "__main__":
    main()
