"""The "pod" axis run for real: training on (pod, data, model) meshes of
gloo ranks, the production mesh's batch axes ("pod", "data") taken
together (FSDP over both, batch rows over both), on llama3.2-1b's
``reduced()`` float32 config, against the JAX package's off-mesh step.

One spawn per mesh, (2, 1, 2) and (2, 2, 1), four ranks each
(``tests/_torch_mesh_ranks.py:train_rank``): JAX's seed-0 params handed
over through numpy, cut by ``shard_params(fsdp=True)``, then 3 steps of
``make_train_step(layout=)`` at batch 8 x 16 tokens.  Held: each step's
loss, CE, aux, gradient norm and lr within 1e-4 relative of JAX's jitted
step; the first batch's gradients, gathered whole, every leaf within 1e-5
of its max|g| of ``jax.value_and_grad``; every step's collective calls and
bytes by kind equal to ``chip_smoke._train_collectives`` on the mesh.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ARCH = "llama3.2-1b"
SHAPES = [(2, 1, 2), (2, 2, 1)]
STEPS, BATCH, SEQ = 3, 8, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5          # of each leaf's max|g|


def _named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


@pytest.fixture(scope="module")
def jax_ref():
    jcfg = jreduced(jget_config(ARCH))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    data = pipeline.synthetic_lm_batches(pipeline.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=SEQ, batch_size=BATCH))
    data = [next(data) for _ in range(STEPS)]
    _, jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in
                                           data[0].items()}, remat=False),
        has_aux=True)(jparams)
    step = jax.jit(jtrain.make_train_step(jcfg, jopt.OptimizerConfig(**OPT),
                                          remat=False))
    state, metrics, p = jopt.init_opt_state(jparams), [], jparams
    for b in data:
        p, state, m = step(p, state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": jax.tree.map(np.asarray, jparams), "batches": data,
            "metrics": metrics, "grads": _named(jgrads)}


@pytest.fixture(scope="module")
def runs(jax_ref):
    case = {"arch": ARCH, "params": jax_ref["params"],
            "batches": jax_ref["batches"], "opt": OPT}
    return {shape: run_ranks(ranks.train_rank, 4, shape, [case],
                             timeout_s=240, threads=1)
            for shape in SHAPES}


@pytest.mark.parametrize("shape", SHAPES)
def test_pod_steps_match_jax(runs, jax_ref, shape):
    for r in runs[shape]:
        res = r[0]
        assert res["step"] == STEPS
        for got, want in zip(res["metrics"], jax_ref["metrics"]):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                           atol=1e-6, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_pod_grads_match_jax(runs, jax_ref, shape):
    for r in runs[shape]:
        got = r[0]["grads"]
        assert got.keys() == jax_ref["grads"].keys()
        for k, w in jax_ref["grads"].items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got[k] - w).max()) <= GRAD_TOL * scale, k


@pytest.mark.parametrize("shape", SHAPES)
def test_pod_collectives_match_formula(runs, jax_ref, shape):
    """FSDP over ("pod", "data") (4 or 2 ways), the batch's rows over both:
    every step's calls and bytes by kind as the formula counts them."""
    cfg = ranks.make_cfg(ARCH)
    full = convert.params_from_numpy(jax_ref["params"], cfg, "cpu")
    mesh = tmesh.Mesh(np.arange(4).reshape(shape), ("pod", "data", "model"),
                      groups=False)
    b = shape[0] * shape[1]
    want = chip_smoke._train_collectives(cfg, tmesh.train_layout(full, mesh),
                                         BATCH // b, SEQ)
    assert want["calls"]["all-gather"] > 0
    for r in runs[shape]:
        for step in r[0]["collectives"]:
            for kind, n in want["calls"].items():
                assert step["calls"][kind] == n, (kind, step, want)
                assert step["bytes"][kind] == want["bytes"][kind], (kind, step)
