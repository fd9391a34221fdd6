"""The continuous engine of the SSM, hybrid, vlm and audio families on a
mesh of gloo ranks, against the JAX package's off-mesh streams, as
``tests/test_torch_mesh_engine.py`` holds the dense and MoE families.

Reduced (float32) falcon-mamba, zamba2, internvl2-1b and seamless, JAX's
params from seed 0, 5 requests of 8 tokens (``max_new`` [1, 5, 3, 7, 4];
the vlm's and the audio model's with their frontend embeddings, the vlm's
sharing one image and a 4-token prefix) with 4 slots on (1, 2) and (2, 2)
(the batch splits over "data"), and the vlm with 3 slots on (2, 2) (the
batch spills onto the sequence: its 16 prologue rows sit in the
sequence-sharded cache).  On every mesh and rank the per-step arm, the
local overlapped arm (K=4), the disaggregated arm (a mesh-wide
PrefillWorker) and, for the vlm on (2, 2) with 3 slots, that arm with a
PrefixCache (the prologue root, resumed prefills, KV hops of the rank's
rows) give streams bit-equal to JAX's ``ContinuousServingEngine(
macro_steps=0)``; the profile has the four programs, collective bytes on
the decode loop and the prefill and none on the splice and slot write.
Also the launcher's ``--mesh 1x2`` for each family under
``torch.distributed.run``: rank 0's streams equal the one-rank engine's.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import (ContinuousServingEngine,  # noqa: E402
                                        ServingEngine)

ROOT = Path(__file__).resolve().parents[1]
FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-2.7b"
VLM, AUDIO = "internvl2-1b", "seamless-m4t-medium"
FAMILIES = [FALCON, ZAMBA, VLM, AUDIO]
MAX_NEWS, PROMPT = [1, 5, 3, 7, 4], 8
# (mesh, arch, slots): 4 slots split over "data"; 3 spill onto the sequence
RUNS = [((1, 2), a, 4) for a in FAMILIES] + [((2, 2), a, 4) for a in FAMILIES] \
    + [((2, 2), VLM, 3)]


def _scenario(arch):
    jcfg = jreduced(jget_config(arch))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jcfg.vocab_size, (5, PROMPT)).astype(np.int32)
    frontend = [None] * 5
    if arch == VLM:          # one image and a 4-token prefix for every request
        prompts[:, :4] = prompts[0, :4]
        image = rng.standard_normal((jcfg.frontend_tokens, jcfg.frontend_dim))
        frontend = [image.astype(np.float32)] * 5
    elif jcfg.frontend:
        frontend = list(rng.standard_normal(
            (5, jcfg.frontend_tokens, jcfg.frontend_dim)).astype(np.float32))
    # rows a "data" axis of 2 divides, so 3 slots shard the sequence
    max_len = -(-(PROMPT + (jcfg.frontend_tokens if arch == VLM else 0)
                  + max(MAX_NEWS) + 8) // 8) * 8
    reqs = [jengine.ServeRequest(uid=i, prompt=prompts[i], max_new=m,
                                 frontend=frontend[i])
            for i, m in enumerate(MAX_NEWS)]
    ref, _ = jengine.ContinuousServingEngine(
        jcfg, jparams, slots=2, max_len=max_len, macro_steps=0).run(reqs)
    return {"arch": arch, "params": jax.tree.map(np.asarray, jparams),
            "prompts": list(prompts), "frontend": frontend,
            "max_news": MAX_NEWS, "max_len": max_len,
            "ref": [o.tokens.tolist() for o in ref]}


@pytest.fixture(scope="module")
def scenarios():
    return {arch: _scenario(arch) for arch in FAMILIES}


@pytest.fixture(scope="module")
def results(scenarios):
    """One spawn a mesh, every (arch, slots) of it in turn."""
    out = {}
    for shape in ((1, 2), (2, 2)):
        runs = [(a, s) for sh, a, s in RUNS if sh == shape]
        scs = [dict(scenarios[a], slots=s, cached=s == 3) for a, s in runs]
        res = run_ranks(ranks.family_engine_rank, int(np.prod(shape)), shape,
                        scs, threads=1)
        for j, key in enumerate(runs):
            out[(shape,) + key] = [r[j] for r in res]
    return out


@pytest.mark.parametrize("shape,arch,slots", RUNS)
def test_streams_bit_equal_jax_off_mesh(results, scenarios, shape, arch, slots):
    for res in results[(shape, arch, slots)]:
        arms = ("per_step", "local", "disagg") + (("cached",) if slots == 3
                                                  else ())
        for arm in arms:
            assert res[arm]["streams"] == scenarios[arch]["ref"], \
                (res["rank"], arm)
        assert res["disagg"]["offloaded"] == len(MAX_NEWS)


@pytest.mark.parametrize("shape,arch,slots", RUNS)
def test_cache_block_layout(results, shape, arch, slots):
    """4 slots split over "data" (on (1, 2) trivially); 3 slots on (2, 2)
    spill onto an attention cache's sequence, and leave an SSM model's
    states whole on every rank of a "data" line."""
    for res in results[(shape, arch, slots)]:
        assert res["shard"]["b_sharded"] == (slots % shape[0] == 0)
        assert res["shard"]["seq"] == (slots % shape[0] != 0 and arch != FALCON)
        rows = slots // shape[0] if slots % shape[0] == 0 else slots
        assert all(leaf[1] == rows for leaf in res["cache_block"]), res


def test_vlm_prologue_root_and_kv_hops_on_the_sequence_sharded_cache(results):
    """The cached arm on (2, 2) with 3 slots: requests hit the prologue
    root and its token block (the same ones on every rank: the ranks take
    the same host decisions), and each rank's KV hops carry its own rows,
    compacted."""
    res = results[((2, 2), VLM, 3)]
    hits = {r["cached"]["prefix_hits"] for r in res}
    assert len(hits) == 1 and hits.pop() > 0
    for r in res:
        cached = r["cached"]
        assert 0 < cached["kv_hop_bytes_wire"] < cached["kv_hop_bytes_raw"]


@pytest.mark.parametrize("shape,arch,slots", RUNS)
def test_profile_programs(results, shape, arch, slots):
    for res in results[(shape, arch, slots)]:
        progs = res["profile"]["programs"]
        assert set(progs) == {"decode_loop", "splice", "slot_write", "prefill"}
        assert progs["splice"]["collective_bytes"]["total"] == 0.0
        assert progs["slot_write"]["collective_bytes"]["total"] == 0.0
        assert progs["decode_loop"]["collective_bytes"]["all-reduce"] > 0.0
        assert progs["prefill"]["collective_bytes"]["all-reduce"] > 0.0


# ---------------------------------------------------------------------------
LAUNCH = {FALCON: [], ZAMBA: ["--continuous", "--slots", "2"], VLM: [],
          AUDIO: ["--continuous", "--slots", "2"]}


def _one_rank_tokens(arch, extra, requests, max_new, prompt_len):
    """The launcher's streams on one rank, in this process."""
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    args = argparse.Namespace(requests=requests, prompt_len=prompt_len)
    reqs = serve._request_stream(cfg, args)
    max_len = prompt_len + M.frontend_offset(cfg) + max_new + 8
    if "--continuous" in extra:
        eng = ContinuousServingEngine(cfg, params, slots=2, max_len=max_len,
                                      device="cpu")
        outs, _ = eng.run(serve._serve_requests(cfg, reqs, prompt_len, max_new))
        return {str(o.uid): o.tokens.tolist() for o in outs}
    eng = ServingEngine(cfg, params, max_len=max_len, device="cpu")
    res = eng.generate(np.stack([serve._pad_prompt(r.prompt, prompt_len)
                                 for r in reqs]), max_new=max_new,
                       frontend=np.stack([r.frontend for r in reqs])
                       if cfg.frontend else None)
    return res.tokens.tolist()


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_launcher_serves_every_family(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mesh", "1x2", "--dist-backend", "gloo", "--device", "cpu",
         "--reduced", "--arch", arch, "--requests", "3", "--max-new", "4",
         "--prompt-len", "8"] + LAUNCH[arch],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith("{")]
    assert len(lines) == 1, proc.stdout
    out = lines[0]
    assert out["mesh"] == {"data": 1, "model": 2}
    assert out["arch"] == reduced(get_config(arch)).name
    assert out["mode"] == ("continuous" if LAUNCH[arch] else "static")
    assert out["tokens"] == _one_rank_tokens(arch, LAUNCH[arch], 3, 4, 8)
