"""Each cell for a few seconds on the card, through the benchmark's own
command: correct, every end-to-end metric read.  Skips without a card."""
import json
import subprocess
import sys

import pytest

CELLS = ["nemotron-4-15b.docqa"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, root, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "5", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"tokens_per_s", "ttft_p90_ms",
                                   "setup_s"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
