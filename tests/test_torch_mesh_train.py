"""Training across ranks: llama3.2-1b's ``reduced()`` float32 config on
(data, model) meshes of gloo ranks, against the JAX package's off-mesh
train step (JAX's sharded paths fail on the local jax, and GSPMD's
per-rank layouts are a compiler's choice, so the results are compared).

One spawn per mesh ((2, 2), then (2, 1), then (1, 2);
``tests/_torch_mesh_ranks.py:train_rank``): JAX's seed-0 params handed over
through numpy, cut by ``shard_params(fsdp=True)`` (FSDP over "data", the
serving cuts over "model"), then 3 steps of ``make_train_step(layout=)``
at batch 8 x 16 tokens.  Held to JAX's jitted ``make_train_step``: each
step's loss, CE, aux, gradient norm and lr within 1e-4 relative; the
params after the first step, gathered whole, within 1e-4
(``STEP_LOSS_RTOL`` / ``STEP_PARAM_ATOL``, PR 19's tolerances); the first
batch's gradients, gathered whole from the shards (without and, on (2, 2),
with remat), every leaf within 1e-5 of its max|g| of ``jax.value_and_grad``
(the check a wrong transpose fails); ``global_norm`` on the mesh within
1e-6 relative of the off-mesh norm of those gradients; every step's
collective calls and bytes by kind equal to
``chip_smoke._train_collectives``.  The checkpoint written on (2, 2)
holds the keys, dtypes and bytes of the file one device writes from the
same whole params and state, and restores on (2, 1) bit for bit.  On
(2, 1) also 2 microbatches of each rank's rows against JAX's step with 2
microbatches.  And the train launcher under ``torch.distributed.run --mesh
2x2``.
"""
import os
import subprocess
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
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ARCH = "llama3.2-1b"
SHAPES = [(2, 2), (2, 1), (1, 2)]
STEPS, BATCH, SEQ = 3, 8, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_ATOL = 1e-4
GRAD_TOL = 1e-5          # of each leaf's max|g|
MICROBATCHES = 2
NORM_RTOL = 1e-6


def batches(cfg, n, seq=SEQ, batch=BATCH):
    fe = bool(cfg.frontend)
    data = pipeline.synthetic_lm_batches(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
        frontend_tokens=cfg.frontend_tokens if fe else 0,
        frontend_dim=(cfg.frontend_dim or cfg.d_model) if fe else 0))
    return [next(data) for _ in range(n)]


def jax_named(tree):
    """{JAX key path: numpy array}, spelled as ``checkpoint.named_leaves``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def grads_close(got, want, tol=GRAD_TOL):
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * scale, (k, err, scale)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's seed-0 params, the batches, its jitted step's metrics and
    params after step 1, and the first batch's gradients."""
    jcfg = jreduced(jget_config(ARCH))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    data = batches(jcfg, STEPS)
    _, jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in
                                           data[0].items()}, remat=False),
        has_aux=True)(jparams)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt.OptimizerConfig(**OPT),
                                           remat=False))
    state, metrics, p = jopt.init_opt_state(jparams), [], jparams
    for i, b in enumerate(data):
        p, state, m = jstep(p, state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            step1 = jax_named(p)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt.OptimizerConfig(**OPT),
                                           remat=False,
                                           microbatches=MICROBATCHES))
    state, mb_metrics, p = jopt.init_opt_state(jparams), [], jparams
    for b in data:
        p, state, m = jstep(p, state, {k: jnp.asarray(v) for k, v in b.items()})
        mb_metrics.append({k: float(v) for k, v in m.items()})
    return {"params": np_params, "batches": data, "metrics": metrics,
            "params_step1": step1, "grads": jax_named(jgrads),
            "mb_metrics": mb_metrics}


@pytest.fixture(scope="module")
def runs(jax_ref, tmp_path_factory):
    """One spawn per mesh, (2, 2) first: its checkpoint is what (2, 1)
    restores."""
    path = str(tmp_path_factory.mktemp("mesh_ckpt") / "mesh22.npz")
    base = {"arch": ARCH, "params": jax_ref["params"],
            "batches": jax_ref["batches"], "opt": OPT}
    cases = {(2, 2): [dict(base, save=path, remat_grads=True)],
             (2, 1): [base, {"arch": ARCH, "params": jax_ref["params"],
                             "restore": path},
                      dict(base, microbatches=MICROBATCHES)],
             (1, 2): [base]}
    out = {shape: run_ranks(ranks.train_rank, shape[0] * shape[1], shape,
                            cases[shape], timeout_s=240, threads=1)
           for shape in SHAPES}
    return out, path


@pytest.mark.parametrize("shape", SHAPES)
def test_steps_match_jax(runs, jax_ref, shape):
    for r in runs[0][shape]:
        res = r[0]
        assert res["step"] == STEPS
        for got, want in zip(res["metrics"], jax_ref["metrics"]):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k],
                                           rtol=STEP_LOSS_RTOL, atol=1e-6)
        for k, want in jax_ref["params_step1"].items():
            np.testing.assert_allclose(res["params_step1"][k], want, rtol=0,
                                       atol=STEP_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax(runs, jax_ref, shape):
    for r in runs[0][shape]:
        grads_close(r[0]["grads"], jax_ref["grads"])


def test_remat_grads_match_jax(runs, jax_ref):
    """Under remat each layer's FSDP gather and model sums run again in
    the backward (inside the recomputed function)."""
    for r in runs[0][(2, 2)]:
        grads_close(r[0]["remat_grads"], jax_ref["grads"])


@pytest.mark.parametrize("shape", SHAPES)
def test_global_norm_on_mesh(runs, shape):
    """Each leaf's sum of squares over its replicas, summed over the mesh:
    the off-mesh norm of the whole gradients."""
    for r in runs[0][shape]:
        whole = {k: torch.from_numpy(v) for k, v in r[0]["grads"].items()}
        want = float(opt.global_norm(whole))
        np.testing.assert_allclose(r[0]["global_norm"], want, rtol=NORM_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_collectives_match_formula(runs, jax_ref, shape):
    cfg = ranks.make_cfg(ARCH)
    full = convert.params_from_numpy(jax_ref["params"], cfg, "cpu")
    mesh = tmesh.Mesh(np.arange(shape[0] * shape[1]).reshape(shape),
                      ("data", "model"), groups=False)
    want = chip_smoke._train_collectives(cfg, tmesh.train_layout(full, mesh),
                                         BATCH // shape[0], SEQ)
    for r in runs[0][shape]:
        for step in r[0]["collectives"]:
            for kind, n in want["calls"].items():
                assert step["calls"][kind] == n, (kind, step, want)
                assert step["bytes"][kind] == want["bytes"][kind], \
                    (kind, step, want)
            assert step["calls"]["all-gather"] == \
                (step["calls"]["reduce-scatter"])


def test_microbatches_stay_per_rank(runs, jax_ref):
    """On (2, 1) each rank splits its 4 rows into 2 microbatches: JAX's
    step with 2 microbatches of the whole batch (equal parts, so the same
    mean)."""
    for r in runs[0][(2, 1)]:
        for got, want in zip(r[2]["metrics"], jax_ref["mb_metrics"]):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k],
                                           rtol=STEP_LOSS_RTOL, atol=1e-6)


def test_checkpoint_on_mesh_matches_one_rank_file(runs, tmp_path):
    """The one-device file is written from the whole params and AdamW state
    the mesh's ranks gathered before their write."""
    saved, path = runs[0][(2, 2)][0][0]["saved"], runs[1]
    state = opt.OptState(torch.tensor(saved["step"], dtype=torch.int32),
                         unflatten(saved["m"]), unflatten(saved["v"]))
    one = str(tmp_path / "one.npz")
    ckpt.save_checkpoint(one, unflatten(saved["params"]), state,
                         metadata={"arch": ranks.make_cfg(ARCH).name})
    with np.load(path) as a, np.load(one) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_checkpoint_restores_on_2x1(runs):
    path = runs[1]
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    for r in runs[0][(2, 1)]:
        res = r[1]
        assert res["meta"] == {"arch": ranks.make_cfg(ARCH).name}
        for k, v in res["restored"].items():
            np.testing.assert_array_equal(v, flat["params/" + k])
        assert res["restored_opt"]["step"] == int(flat["opt/.step"])
        for k, v in res["restored_opt"].items():
            if k != "step":
                m_or_v, key = k.split("/", 1)
                np.testing.assert_array_equal(v, flat[f"opt/.{m_or_v}/{key}"])


def unflatten(named):
    """The nested dict of tensors of a {key path: array} map."""
    tree: dict = {}
    for k, v in named.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(v)
    return tree


def test_train_launcher_on_a_mesh(tmp_path):
    """``torch.distributed.run`` of the train launcher on a (2, 2) mesh over
    gloo: rank 0 prints ``mesh=`` and the log; the checkpoint holds whole
    leaves that JAX's ``restore_checkpoint`` reads."""
    path = tmp_path / "mesh_train.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--mesh", "2x2", "--dist-backend", "gloo", "--device", "cpu",
         "--reduced", "--steps", "3", "--ckpt", str(path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("mesh={'data': 2, 'model': 2}  arch=llama3.2-1b")
    assert sum(line.startswith("step ") for line in lines) == 3
    assert any(line.startswith("done: 3 steps") for line in lines)
    jcfg = jreduced(jget_config(ARCH))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    p, s, meta = jckpt.restore_checkpoint(str(path), jparams,
                                          jopt.init_opt_state(jparams))
    assert meta == {"arch": jcfg.name, "steps": 3} and int(s.step) == 3
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(p))
