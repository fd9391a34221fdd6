"""A later cell needs only new files and new entries: in a copy of the
benchmark, one new traffic mix, one new metric reader, a limits file and
one cell entry are enough for the harness to run the cell and read the
metric; no file that was there changes."""
import hashlib
import json
import shutil
from pathlib import Path

import pb_small

PB = Path(__file__).resolve().parent.parent


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_by_added_files_only(tmp_path, root):
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(Path(root) / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"

    mix = json.loads((pb / "traffic" / "docqa.json").read_text())
    mix.update(name="docqa_short", prompt_len=512,
               output_len=dict(mix["output_len"], median=8, max=32))
    (pb / "traffic" / "docqa_short.json").write_text(json.dumps(mix))
    (pb / "metrics" / "served_requests.py").write_text(
        '"""Requests served in every batch of the run."""\n'
        'LAYER, UNIT, SOURCE = "fleet runtime", "requests", '
        '"program_counter"\nMOVES = "tokens_per_s"\n\n\n'
        'def read(run):\n'
        '    return sum(w["n"] for w in run.waves)\n')
    cell = "nemotron-4-15b.docqa_short"
    (pb / "limits" / f"{cell}.json").write_text('{"logit_gap": 0.5}')
    # the one edit the new cell makes: entries appended to BENCHMARK.json
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": "nemotron-4-15b",
                               "traffic": "docqa_short", "chips": 1,
                               "why": "a shorter document mix"})
    bench["per_layer"].append({"name": "served_requests", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "fleet runtime", "moves": "tokens_per_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    over = dict(pb_small.MIX, prompt_len=256)
    from portbench import harness
    res = harness.run_cell(tmp_path, cell, 77, 0.3, True, device="cpu",
                           look_for_chip=False, mix_override=over,
                           config_override=pb_small.CONFIGS[
                               "nemotron-4-15b.docqa"],
                           limits_override=pb_small.LIMITS)
    assert res["correct"]
    assert res["metrics"]["served_requests"]["value"] == res["attempted"]
    res = harness.run_cell(tmp_path, cell, 77, 0.3, False, device="cpu",
                           look_for_chip=False, mix_override=over,
                           config_override=pb_small.CONFIGS[
                               "nemotron-4-15b.docqa"],
                           limits_override=pb_small.LIMITS)
    assert set(res["metrics"]) == {"tokens_per_s", "ttft_p90_ms",
                                   "setup_s"}
    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {Path("BENCHMARK.json")}
