"""The port's example twins against the JAX package's examples: the
host-only ``quickstart_torch.py`` and ``mobility_sim_torch.py`` print what
``quickstart.py`` and ``mobility_sim.py`` print, line for line (the same
r*, 0.73 in both beside the paper's 0.70, and the same decision timeline); ``serve_offload_torch.py --device cpu``
finishes, and with JAX's reduced() llama3.2-1b weights (seeds 0 and 7,
handed over through numpy) every split's outputs, the continuous run's
streams and the star session's streams equal JAX's ``ServingEngine``
greedy streams on the same prompts (float32; exact)."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _run(script):
    proc = subprocess.run([sys.executable, str(EX / script)], env=ENV,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("name", ["quickstart", "mobility_sim"])
def test_host_example_matches_jax(name):
    got, want = _run(f"{name}_torch.py"), _run(f"{name}.py")
    assert got == want
    if name == "quickstart":
        assert "r* = 0.73 (paper: 0.70)" in got


def _serve_offload():
    spec = importlib.util.spec_from_file_location(
        "serve_offload_torch", EX / "serve_offload_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_offload_streams_match_jax():
    arch = "llama3.2-1b"
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jp = {s: jM.init_params(jcfg, jax.random.PRNGKey(s)) for s in (0, 7)}
    tp = {s: convert.params_from_numpy(jax.tree.map(np.asarray, p), cfg, "cpu")
          for s, p in jp.items()}
    out = _serve_offload().run(arch, 24, "cpu", params=tp[0], params_b=tp[7])
    prompts = out["prompts"]
    want = {s: np.asarray(JServingEngine(jcfg, jp[s], max_len=64).generate(
        prompts, max_new=8).tokens) for s in (0, 7)}
    for r, rep in out["reports"].items():
        np.testing.assert_array_equal(np.asarray(rep.outputs), want[0],
                                      err_msg=f"r={r}")
    # the continuous run: each request's first max_new tokens
    streams = {o.uid: o.tokens for task in out["continuous"].outputs.values()
               for o in task}
    assert len(streams) == 24
    for uid, toks in streams.items():
        np.testing.assert_array_equal(toks, want[0][uid, :len(toks)])
    # the star session: task a on seed 0's weights, task b on seed 7's
    reqs = {r.uid: r for r in out["session_requests"]}
    for task, seed in (("vision-a", 0), ("vision-b", 7)):
        for o in out["session"].outputs[task]:
            row = int(np.flatnonzero((prompts == reqs[o.uid].prompt)
                                     .all(axis=1))[0])
            assert len(o.tokens) == reqs[o.uid].max_new
            np.testing.assert_array_equal(o.tokens,
                                          want[seed][row, :len(o.tokens)])
    packed, idx, count, mask = out["payload"]
    assert int(count.sum()) == int(mask.sum())
