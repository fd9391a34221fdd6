#!/usr/bin/env python3
"""Read the moonlight-16b-a3b.longdoc check on planted faults at full size.

    python3 tools/read_mla_faults.py --seeds 3100000701 3100000702 ... \
        [--faults bias_dropped ...] [--slots 8] [--out FILE]

For each seed, the cell's check (``portbench.harness.run_cell``: the
served tokens' ``logit_gap`` against the float32 reference, at the cell's
limit) on the program as it is and with each planted fault of
``portbench/tests/test_pb_mla_moe.py`` (the routing bias dropped, the
shared experts dropped, the latent RMSNorm skipped, the 2.446 routed
scaling omitted): the published model at full size and the cell's
7,168-token prompts, one batch of ``--slots`` a group so a run takes
seconds.  A fault the check catches reads ``correct`` false.  Prints one
JSON line a run (and appends it to ``--out``); needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "moonlight-16b-a3b.longdoc"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="the faults to plant, \"none\" for the program as "
                         "it is (default: none, then all four)")
    ap.add_argument("--slots", type=int, default=8,
                    help="slots a group in the one batch")
    ap.add_argument("--out", default=None, help="a file to append lines to")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "portbench" / "tests")]
    import pytest

    from portbench import harness
    from test_pb_mla_moe import FAULTS

    faults = args.faults if args.faults is not None \
        else ["none"] + sorted(FAULTS)
    mix = {"slots": args.slots, "waves_of_slots": 2}
    for seed in args.seeds:
        for fault in faults:
            with pytest.MonkeyPatch.context() as mp:
                if fault != "none":
                    FAULTS[fault](mp)
                res = harness.run_cell(ROOT, CELL, seed, 1.0, False,
                                       mix_override=mix)
            line = {"seed": seed, "fault": fault,
                    "correct": res["correct"],
                    "logit_gap": res["compared"]["logit_gap"]["value"],
                    "limit": res["compared"]["logit_gap"]["limit"],
                    "attempted": res["attempted"]}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
