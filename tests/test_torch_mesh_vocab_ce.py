"""The vocab-parallel cross-entropy of training on a mesh
(``layers.vocab_block_logits`` and ``model.cross_entropy(vocab=)``), on
(data, model) meshes of gloo ranks, against the JAX package's off-mesh
``cross_entropy`` and ``loss_fn``.

One spawn a mesh, (1, 2), (2, 2) and (1, 4)
(``tests/_torch_mesh_ranks.py:vocab_ce_rank``):

* the loss alone: a [V, D] table cut on its vocab rows (V = 24, which
  the axis divides) or on its D columns (V = 21, which it does not: the
  last block is padded), labels at both edges of every rank's block and
  in the last one, with and without a loss mask: each rank's block has
  ⌈V/m⌉ columns from ``start`` i ⌈V/m⌉; the loss within 1e-5 relative
  of JAX's ``cross_entropy(x @ table.T)``, the gradients of x and of
  the rank's part of the table within 1e-5 of their max|g|;
* the train step: ``reduced()`` float32 llama3.2-1b with a 516-row
  vocabulary (the vocab cut) and internvl2-1b with a 509-row one (the
  table on D; the loss on the vlm's F-1 window), JAX's params from a seed
  handed over through numpy, FSDP on: the train-mode logits of each rank
  are [B_loc, S', ⌈V/m⌉]; no operator of ``step_grads`` returns a tensor
  whose last dim is V; its loss within 1e-5 relative of
  ``jax.value_and_grad(loss_fn)``'s and its gradients, gathered whole,
  every leaf within 1e-5 of its max|g|; one ``make_train_step`` step's
  collective calls and bytes by kind equal to
  ``chip_smoke._train_collectives``.
"""
import dataclasses
import math
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
from repro.training import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from test_torch_mesh_train import batches, grads_close, jax_named  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

MESHES = [(1, 2), (2, 2), (1, 4)]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of each gradient's max|g|

# the loss alone: (cut, V) and the shapes of x
BLOCK_V = {"vocab": 24, "d": 21}
B, S, D = 3, 8, 8
BLOCK_CASES = [(shape, cut, masked) for shape in MESHES
               for cut in BLOCK_V for masked in (False, True)]

# the train step: (name, arch, replace)
BATCH, SEQ = 4, 16
MODELS = [("llama-vocab", "llama3.2-1b", {"vocab_size": 516}),
          ("vlm-d", "internvl2-1b", {"vocab_size": 509})]
MODEL_CASES = [(shape, name) for shape in MESHES for name, _, _ in MODELS]


def _block_id(c):
    return f"{c[0][0]}x{c[0][1]}-{c[1]}{'-mask' if c[2] else ''}"


def _model_id(c):
    return f"{c[0][0]}x{c[0][1]}-{c[1]}"


def _edge_labels(rng, V, m):
    """[B, S] labels holding both edges of every rank's block of
    ⌈V/m⌉ (the last one's real edge V - 1 too), the rest at random."""
    n = -(-V // m)
    edges = sorted({e for i in range(m) for e in (i * n, i * n + n - 1)
                    if e < V} | {V - 1})
    flat = rng.integers(0, V, size=B * S)
    flat[:len(edges)] = edges
    return rng.permutation(flat).reshape(B, S).astype(np.int32)


def _block_inputs(i, shape, cut, masked):
    rng = np.random.default_rng(100 + i)
    V = BLOCK_V[cut]
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    labels = _edge_labels(rng, V, shape[1])
    mask = (rng.random((B, S)) > 0.3) if masked else None
    return dict(x=x, table=table, labels=labels, mask=mask)


def _jax_block(inp):
    def loss(x, t):
        return jM.cross_entropy(x @ t.T, jnp.asarray(inp["labels"]),
                                None if inp["mask"] is None
                                else jnp.asarray(inp["mask"]))
    val, (gx, gt) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(inp["x"]), jnp.asarray(inp["table"]))
    return {"loss": float(val), "gx": np.asarray(gx), "gt": np.asarray(gt)}


def _jax_model(i, arch, replace):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **replace)
    jp = jM.init_params(jcfg, jax.random.PRNGKey(20 + i))
    batch = batches(jcfg, 1, seq=SEQ, batch=BATCH)[0]
    (loss, parts), g = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in
                                           batch.items()}, remat=False),
        has_aux=True))(jp)
    return {"params": jax.tree.map(np.asarray, jp), "batch": batch,
            "loss": float(loss), "ce": float(parts["ce"]),
            "grads": jax_named(g)}


@pytest.fixture(scope="module")
def refs():
    blocks = {}
    for i, c in enumerate(BLOCK_CASES):
        inp = _block_inputs(i, *c)
        blocks[_block_id(c)] = (inp, _jax_block(inp))
    models = {name: _jax_model(i, arch, replace)
              for i, (name, arch, replace) in enumerate(MODELS)}
    return {"blocks": blocks, "models": models}


@pytest.fixture(scope="module")
def runs(refs):
    out = {}
    for shape in MESHES:
        blocks = [c for c in BLOCK_CASES if c[0] == shape]
        models = [c for c in MODEL_CASES if c[0] == shape]
        cases = [dict(kind="block", cut=c[1],
                      **refs["blocks"][_block_id(c)][0]) for c in blocks]
        for c in models:
            _, arch, replace = _model(c[1])
            ref = refs["models"][c[1]]
            cases.append(dict(kind="model", arch=arch, replace=replace,
                              fsdp=True, params=ref["params"],
                              batch=ref["batch"]))
        res = run_ranks(ranks.vocab_ce_rank, math.prod(shape), shape, cases,
                        timeout_s=240, threads=1)
        ids = [_block_id(c) for c in blocks] + [_model_id(c) for c in models]
        for j, key in enumerate(ids):
            out[key] = [r[j] for r in res]
    return out


def _model(name):
    return next(m for m in MODELS if m[0] == name)


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("case", BLOCK_CASES, ids=_block_id)
def test_block_loss_and_grads_match_jax(runs, refs, case):
    shape, cut, _ = case
    inp, want = refs["blocks"][_block_id(case)]
    V, m = BLOCK_V[cut], shape[1]
    n = -(-V // m)
    for r in runs[_block_id(case)]:
        assert r["width"] == n and r["start"] == r["mi"] * n
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOSS_RTOL)
        _close(r["gx"], want["gx"])
        if cut == "d":
            part = want["gt"][:, r["mi"] * (D // m):(r["mi"] + 1) * (D // m)]
        else:
            part = want["gt"][r["mi"] * n:(r["mi"] + 1) * n]
        _close(r["gt"], part)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_model_id)
def test_train_logits_are_the_rank_block(runs, refs, case):
    shape, name = case
    _, arch, replace = _model(name)
    cfg = ranks.make_cfg(arch, **replace)
    V, m = cfg.vocab_size, shape[1]
    rows = SEQ + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    for r in runs[_model_id(case)]:
        assert r["logits_shape"] == (BATCH // shape[0], rows, -(-V // m))
        assert V not in r["last_dims"], r["last_dims"]


@pytest.mark.parametrize("case", MODEL_CASES, ids=_model_id)
def test_train_loss_and_grads_match_jax(runs, refs, case):
    ref = refs["models"][case[1]]
    for r in runs[_model_id(case)]:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["ce"], ref["ce"], rtol=LOSS_RTOL)
        grads_close(r["grads"], ref["grads"], tol=GRAD_TOL)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_model_id)
def test_step_collectives_match_formula(runs, refs, case):
    shape, name = case
    _, arch, replace = _model(name)
    cfg = ranks.make_cfg(arch, **replace)
    full = convert.params_from_numpy(refs["models"][name]["params"], cfg,
                                     "cpu")
    mesh = tmesh.Mesh(np.arange(math.prod(shape)).reshape(shape),
                      ("data", "model"), groups=False)
    want = chip_smoke._train_collectives(
        cfg, tmesh.train_layout(full, mesh), BATCH // shape[0], SEQ)
    for r in runs[_model_id(case)]:
        got = r["collectives"]
        for kind, n in want["calls"].items():
            assert got["calls"][kind] == n, (kind, got, want)
            assert got["bytes"][kind] == want["bytes"][kind], (kind, got, want)
