"""The port's sharded serving engine against the JAX package's off-mesh
streams, held to ``tests/test_scaleout.py``'s contract.

test_scaleout's scenario -- reduced llama3.2-1b with one kv head, 2 slots,
``max_len=32``, requests ``max_new`` [1, 5, 3, 7, 4] from seed 3 -- on a
(4, 2) gloo mesh of 8 ranks (the batch spills onto the sequence, which
shards 8 ways), and with 4 slots on (1, 2) and (2, 2) meshes (the batch
shards over "data").  On every mesh and rank: the disaggregated arm (a
mesh-wide PrefillWorker, ``macro_steps=4``), the local arm and the
per-step arm give streams bit-equal to JAX's off-mesh
``ContinuousServingEngine(macro_steps=0)`` streams; the disaggregated arm
has 0 stalls and 5 prefills offloaded; ``decode_s == t_dispatch_s +
t_await_s`` exactly; the boundary wall lands in ``t_splice_s`` on the
disaggregated arm and ``t_slot_write_s`` on the local one; the profile has
the four programs and zero collective bytes on ``splice`` and
``slot_write``.  Also the launcher's ``--mesh`` under
``torch.distributed.run``: one JSON result, from rank 0.
"""
import dataclasses
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
from repro_torch.distributed.spawn import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH, REPLACE = "llama3.2-1b", {"num_kv_heads": 1}
MAX_NEWS, MAX_LEN = [1, 5, 3, 7, 4], 32
# (data, model) -> slots: test_scaleout's 8 ranks, then a split batch
MESHES = {(4, 2): 2, (1, 2): 4, (2, 2): 4}


@pytest.fixture(scope="module")
def scenario():
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)), **REPLACE)
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jcfg.vocab_size, (5, 8)).astype(np.int32)
    reqs = [jengine.ServeRequest(uid=i, prompt=prompts[i], max_new=m)
            for i, m in enumerate(MAX_NEWS)]
    ref, _ = jengine.ContinuousServingEngine(
        jcfg, jparams, slots=2, max_len=MAX_LEN, macro_steps=0).run(reqs)
    return {"params": jax.tree.map(np.asarray, jparams), "prompts": prompts,
            "ref": [o.tokens.tolist() for o in ref]}


@pytest.fixture(scope="module")
def results(scenario):
    return {shape: run_ranks(ranks.engine_rank, int(np.prod(shape)), shape,
                             ARCH, REPLACE, scenario["params"],
                             scenario["prompts"], MAX_NEWS, slots, MAX_LEN,
                             threads=1)
            for shape, slots in MESHES.items()}


@pytest.mark.parametrize("shape", list(MESHES))
def test_streams_bit_equal_jax_off_mesh(results, scenario, shape):
    for res in results[shape]:
        assert res["mesh"] == {"data": shape[0], "model": shape[1]}
        for arm in ("disagg", "local", "per_step"):
            assert res[arm]["streams"] == scenario["ref"], (res["rank"], arm)


@pytest.mark.parametrize("shape", list(MESHES))
def test_disaggregated_arm_offloads_every_prefill(results, shape):
    for res in results[shape]:
        assert res["disagg"]["stalls"] == 0
        assert res["disagg"]["offloaded"] == 5


@pytest.mark.parametrize("shape", list(MESHES))
def test_buckets_sum_to_decode_wall(results, shape):
    for res in results[shape]:
        for arm in ("disagg", "local"):
            e = res[arm]
            assert e["decode_s"] == e["t_dispatch_s"] + e["t_await_s"], e


@pytest.mark.parametrize("shape", list(MESHES))
def test_boundary_wall_lands_in_the_right_bucket(results, shape):
    for res in results[shape]:
        d, l = res["disagg"], res["local"]
        assert d["t_splice_s"] > 0.0 and d["t_slot_write_s"] == 0.0, d
        assert l["t_slot_write_s"] > 0.0 and l["t_splice_s"] == 0.0, l


@pytest.mark.parametrize("shape", list(MESHES))
def test_profile_splice_and_slot_write_move_no_collective_bytes(results, shape):
    for res in results[shape]:
        prof = res["profile"]
        assert prof["device_count"] == shape[0] * shape[1]
        progs = prof["programs"]
        assert set(progs) == {"decode_loop", "splice", "slot_write", "prefill"}
        for rec in progs.values():
            assert set(rec) >= {"flops", "bytes_accessed", "collective_bytes"}
            assert "total" in rec["collective_bytes"]
        assert progs["splice"]["collective_bytes"]["total"] == 0.0, progs
        assert progs["slot_write"]["collective_bytes"]["total"] == 0.0, progs
        assert progs["decode_loop"]["collective_bytes"]["all-reduce"] > 0.0


def test_cache_blocks_follow_seq_shard_layout(results):
    """Each rank allocates only its block: (4, 2) with 2 slots spills the
    batch onto the sequence, cut 8 ways; 4 slots split over "data", the
    sequence over "model" (one kv head does not divide it)."""
    L, dh = 2, 64
    want = {(4, 2): [L, 2, 4, 1, dh], (1, 2): [L, 4, 16, 1, dh],
            (2, 2): [L, 2, 16, 1, dh]}
    for shape, res in results.items():
        for r in res:
            assert r["cache_block"] == want[shape], (shape, r["rank"])


def test_mesh_launcher_prints_one_result_from_rank_0():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mesh", "1x2", "--dist-backend", "gloo", "--device", "cpu",
         "--reduced", "--requests", "4", "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith("{")]
    assert len(lines) == 1, proc.stdout
    out = lines[0]
    assert out["mesh"] == {"data": 1, "model": 2} and out["backend"] == "gloo"
    assert out["mode"] == "static" and len(out["tokens"]) == 4
    assert all(len(t) == 4 for t in out["tokens"])


def test_mesh_launcher_rejects_single_rank_flags():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mesh", "1x2",
         "--device", "cpu", "--reduced", "--topology", "star"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "do not apply" in proc.stderr
