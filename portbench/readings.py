"""The readings a cell's ``logit_gap`` limit is set from: the program's
widest gap on many seeds and the fp8 control's on some of them, each a
run of one batch at the cell's own load, all in one process.

    python3 portbench/readings.py --workload <cell> --seeds 101 102 ... \
        [--control-seeds 101 102 103] [--out readings.jsonl]

One JSON line a seed: the program's gap, the control's where asked (the
run's ``correct`` is then the control's verdict, to come out false), the
requests compared.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as entry
    entry.prepare()
    from portbench import harness
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = harness.run_cell(ROOT, args.workload, seed, 1.0, False,
                               control=seed in args.control_seeds)
        judged = res["compared"]["logit_gap"]["value"]
        control = seed in args.control_seeds
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"],
                "logit_gap": res.get("served_logit_gap", judged),
                "control_logit_gap": judged if control else None,
                "unanswered": res["compared"]["unanswered"]["value"],
                "attempted": res["attempted"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
