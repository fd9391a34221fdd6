#!/usr/bin/env python3
"""Repeat chip_smoke.py's continuous phase on one NVIDIA card.

    python3 tools/repeat_continuous.py [--runs 3]

Builds the kernels, loads llama3.2-1b at full width (bf16, random weights
from seed 0) and runs ``chip_smoke.phase_continuous`` (seven modes on the
same 24 requests; streams of the first six compared request by request,
launch counts held) and ``phase_continuous_checks`` ``--runs`` times.  The
overlapped modes order the decode stream after each shadow prefill's event
on the side stream; a missing wait would show as streams that differ in
some runs only.  Prints chip_smoke's JSON lines, then one summary line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    sys.path.insert(0, str(cs.SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_env(torch)
    cs.phase_build()
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(cs.ARCH)
    params = M.init_params(cfg, 0, device=dev)
    walls = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        cs.phase_continuous(torch, dev, cfg, params)
        cs.phase_continuous_checks(torch, dev, cfg, params)
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"runs": args.runs, "seconds": walls, "all_checks_held": True,
                      **cs._CARD}), flush=True)


if __name__ == "__main__":
    main()
