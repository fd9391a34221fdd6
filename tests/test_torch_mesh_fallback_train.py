"""Training under JAX's ``param_spec`` fallback cuts (Case Q, Case D, a
table and ``frontend_proj`` on D: ``tests/test_torch_mesh_fallback.py``),
on meshes of gloo ranks, against the JAX package's off-mesh step.

``reduced()`` float32 configs with ``dataclasses.replace`` applied alike
to JAX's config and the port's, JAX's params from a seed handed over
through numpy, one batch of 4 x 16 tokens (with the frontend embeddings of
the vlm and the audio model):

* Case Q: llama with one kv head on (2, 2), with FSDP (and remat) and
  without; llama with 12 / 6 heads of 16 on (1, 4) (a rank's query heads
  span two kv heads); seamless with one kv head and a 509-row vocabulary
  on (2, 2) with FSDP;
* Case D: internvl2-1b with a 509-row vocabulary and 3 / 1 heads of 32 on
  (2, 2), with FSDP and without; with 6 / 2 heads of 32 on (1, 4);
  seamless with 6 / 2 heads of 32 on (1, 4).

One spawn per mesh (``tests/_torch_mesh_ranks.py:fallback_train_rank``).
Held on every rank: each leaf's bytes equal to JAX's ``param_spec`` with
and without FSDP; ``step_grads``' loss and CE within 1e-4 relative of
``jax.value_and_grad(loss_fn)``'s; its gradients, gathered whole, every
leaf within 1e-5 of its max|g| of JAX's (the check a wrong transpose
fails; under remat too); one ``make_train_step`` step's collective calls
and bytes by kind equal to ``chip_smoke._train_collectives``.
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
from repro.launch.mesh import param_spec as jparam_spec  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from test_torch_mesh_fallback import D_14, D_22, ODD_VOCAB, Q_SPAN  # noqa: E402
from test_torch_mesh_train import batches, grads_close, jax_named  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LLAMA, VLM, AUDIO = "llama3.2-1b", "internvl2-1b", "seamless-m4t-medium"
BATCH, SEQ = 4, 16
LOSS_RTOL = 1e-4

# (name, arch, replace, mesh, fsdp, remat): the JAX reference is per
# (arch, replace)
CASES = [
    ("llama-q-fsdp", LLAMA, {"num_kv_heads": 1}, (2, 2), True, True),
    ("llama-q", LLAMA, {"num_kv_heads": 1}, (2, 2), False, False),
    ("llama-q-span", LLAMA, Q_SPAN, (1, 4), False, False),
    ("audio-q-fsdp", AUDIO, {"num_kv_heads": 1, "vocab_size": ODD_VOCAB},
     (2, 2), True, False),
    ("vlm-d-fsdp", VLM, D_22, (2, 2), True, True),
    ("vlm-d", VLM, D_22, (2, 2), False, False),
    ("vlm-d14", VLM, D_14, (1, 4), False, False),
    ("audio-d14", AUDIO, D_14, (1, 4), False, False),
]
MESHES = sorted({c[3] for c in CASES})
NAMES = [c[0] for c in CASES]


def _key(case):
    return (case[1], tuple(sorted(case[2].items())))


def _jax_ref(i, arch, replace):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **replace)
    jp = jM.init_params(jcfg, jax.random.PRNGKey(10 + i))
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
    keys = list(dict.fromkeys(_key(c) for c in CASES))
    return {k: _jax_ref(i, k[0], dict(k[1])) for i, k in enumerate(keys)}


@pytest.fixture(scope="module")
def runs(refs):
    out = {}
    for shape in MESHES:
        cases = [c for c in CASES if c[3] == shape]
        rank_cases = [dict(arch=c[1], replace=c[2], fsdp=c[4], remat=c[5],
                           params=refs[_key(c)]["params"],
                           batch=refs[_key(c)]["batch"]) for c in cases]
        res = run_ranks(ranks.fallback_train_rank, math.prod(shape), shape,
                        rank_cases, timeout_s=240, threads=1)
        for j, c in enumerate(cases):
            out[c[0]] = [r[j] for r in res]
    return out


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", NAMES)
def test_param_bytes_match_jax_spec(runs, refs, name):
    c = _case(name)
    shape, fsdp = c[3], c[4]
    sizes = {"data": shape[0], "model": shape[1]}
    flat, _ = jax.tree_util.tree_flatten_with_path(refs[_key(c)]["params"])
    want = {}
    for path, a in flat:
        names = tuple(str(getattr(k, "key", k)) for k in path)
        spec = jparam_spec(path, a.shape, model_size=shape[1],
                           data_size=shape[0], stacked=tmesh._stacked(names),
                           fsdp=fsdp)
        n = a.size * a.dtype.itemsize
        for e in spec:
            n //= sizes[e] if e else 1
        want["/".join(names)] = n
    for r in runs[name]:
        assert r["param_bytes"] == want


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_jax(runs, refs, name):
    ref = refs[_key(_case(name))]
    for r in runs[name]:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["ce"], ref["ce"], rtol=LOSS_RTOL)
        grads_close(r["grads"], ref["grads"])
        if "remat_grads" in r:
            grads_close(r["remat_grads"], ref["grads"])


@pytest.mark.parametrize("name", NAMES)
def test_step_collectives_match_formula(runs, refs, name):
    _, arch, replace, shape, fsdp, _ = _case(name)
    cfg = ranks.make_cfg(arch, **replace)
    full = convert.params_from_numpy(refs[_key(_case(name))]["params"], cfg,
                                     "cpu")
    mesh = tmesh.Mesh(np.arange(math.prod(shape)).reshape(shape),
                      ("data", "model"), groups=False)
    want = chip_smoke._train_collectives(
        cfg, tmesh.train_layout(full, mesh, fsdp=fsdp), BATCH // shape[0],
        SEQ)
    for r in runs[name]:
        got = r["collectives"]
        for kind, n in want["calls"].items():
            assert got["calls"][kind] == n, (kind, got, want)
            assert got["bytes"][kind] == want["bytes"][kind], (kind, got, want)
