"""Training across ranks for the MoE, SSM, hybrid, vlm and audio families:
moonshot-v1-16b-a3b, falcon-mamba-7b, zamba2-2.7b, internvl2-1b and
seamless-m4t-medium at ``reduced()`` float32 size on a (2, 2) mesh of gloo
ranks (one spawn; ``tests/_torch_mesh_ranks.py:train_rank``), 3 steps of
``make_train_step(layout=)`` at batch 4 x 16 tokens (the vlm and audio
with their stubbed frontends).

The reference is JAX's per-shard step: ``jax.value_and_grad(loss_fn)`` on
each "data" shard's rows, averaged, then JAX's ``adamw_update``.  That is
what JAX's ``_moe_shardmap`` computes under a mesh (each shard's capacity
from its own tokens, the aux pmean'd over the batch axes), and for the
other families it equals the whole batch's step.  Held as
``tests/test_torch_mesh_train.py`` holds llama: each step's metrics within
1e-4 relative, the params after step 1 within 1e-4, the first batch's
gradients gathered from the shards (and, for moonshot and falcon-mamba,
under remat) every leaf within 1e-5 of its max|g|, the collectives of
every step equal to ``chip_smoke._train_collectives``.
"""
import functools

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
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from test_torch_mesh_train import (OPT, STEP_LOSS_RTOL,  # noqa: E402
                                   STEP_PARAM_ATOL, batches, chip_smoke,
                                   grads_close, jax_named)

ARCHS = ["moonshot-v1-16b-a3b", "falcon-mamba-7b", "zamba2-2.7b",
         "internvl2-1b", "seamless-m4t-medium"]
REMAT = ("moonshot-v1-16b-a3b", "falcon-mamba-7b")
SHAPE = (2, 2)
STEPS, BATCH, SEQ = 3, 4, 16


def jax_sharded_step(jcfg, opt_cfg, params, state, batch, n_shards):
    """JAX's step as its mesh computes it: each data shard's loss and
    gradients, averaged, then AdamW.  Returns (params, state, metrics,
    grads)."""
    vg = _value_and_grad(jcfg)
    rows = batch["tokens"].shape[0] // n_shards
    outs = [vg(params, {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                        for k, v in batch.items()}) for i in range(n_shards)]
    grads = jax.tree.map(lambda *g: sum(g) / n_shards, *[o[1] for o in outs])
    loss = sum(o[0][0] for o in outs) / n_shards
    parts = {k: sum(o[0][1][k] for o in outs) / n_shards for k in ("ce", "aux")}
    params, state, stats = jopt.adamw_update(opt_cfg, grads, state, params)
    metrics = {"loss": loss, **parts, **stats}
    return params, state, {k: float(v) for k, v in metrics.items()}, grads


@functools.lru_cache(maxsize=None)
def _value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.loss_fn(p, jcfg, b, remat=False), has_aux=True))


@pytest.fixture(scope="module")
def refs():
    out = {}
    for arch in ARCHS:
        jcfg = jreduced(jget_config(arch))
        jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
        data = batches(jcfg, STEPS, SEQ, BATCH)
        opt_cfg = jopt.OptimizerConfig(**OPT)
        p, state, metrics = jparams, jopt.init_opt_state(jparams), []
        for i, b in enumerate(data):
            p, state, m, g = jax_sharded_step(jcfg, opt_cfg, p, state, b,
                                              SHAPE[0])
            metrics.append(m)
            if i == 0:
                step1, grads = jax_named(p), jax_named(g)
        out[arch] = {"params": jax.tree.map(np.asarray, jparams),
                     "batches": data, "metrics": metrics,
                     "params_step1": step1, "grads": grads}
    return out


@pytest.fixture(scope="module")
def runs(refs):
    cases = [{"arch": a, "params": refs[a]["params"],
              "batches": refs[a]["batches"], "opt": OPT,
              "remat_grads": a in REMAT} for a in ARCHS]
    res = run_ranks(ranks.train_rank, SHAPE[0] * SHAPE[1], SHAPE, cases,
                    timeout_s=240, threads=1)
    return {a: [r[i] for r in res] for i, a in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_jax_per_shard(runs, refs, arch):
    for res in runs[arch]:
        assert res["step"] == STEPS
        for got, want in zip(res["metrics"], refs[arch]["metrics"]):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k],
                                           rtol=STEP_LOSS_RTOL, atol=1e-6,
                                           err_msg=k)
        for k, want in refs[arch]["params_step1"].items():
            np.testing.assert_allclose(res["params_step1"][k], want, rtol=0,
                                       atol=STEP_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_per_shard(runs, refs, arch):
    for res in runs[arch]:
        grads_close(res["grads"], refs[arch]["grads"])
        if arch in REMAT:
            grads_close(res["remat_grads"], refs[arch]["grads"])


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_match_formula(runs, refs, arch):
    cfg = ranks.make_cfg(arch)
    full = convert.params_from_numpy(refs[arch]["params"], cfg, "cpu")
    mesh = tmesh.Mesh(np.arange(4).reshape(SHAPE), ("data", "model"),
                      groups=False)
    want = chip_smoke._train_collectives(cfg, tmesh.train_layout(full, mesh),
                                         BATCH // SHAPE[0], SEQ)
    for res in runs[arch]:
        for step in res["collectives"]:
            got = {k: step["calls"][k] for k in want["calls"]}
            assert got == want["calls"], (arch, got, want)
            got = {k: step["bytes"][k] for k in want["bytes"]}
            assert got == want["bytes"], (arch, got, want)
