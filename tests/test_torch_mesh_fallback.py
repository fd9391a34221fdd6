"""Serving under JAX's ``param_spec`` fallback cuts, on meshes of gloo
ranks, against the JAX package's off-mesh functions.

``launch.mesh.shard_params`` cuts every attention projection, vocab table
and ``frontend_proj`` on the dim ``param_spec`` gives, its fallback
included (``launch.mesh.ATTN_CUTS``): Case Q ("q", the axis divides the
query heads only: wk/wv on their D rows), Case D ("d", it divides
neither: every projection on D), a table on its D columns where the axis
does not divide the vocabulary, ``frontend_proj`` on D.  The configs are
``reduced()`` float32 ones with ``dataclasses.replace`` applied alike to
JAX's config and the port's:

* Case Q: llama with 2 kv heads on (1, 4); with 12 heads / 6 kv heads of
  16 on (1, 4), where a rank's 3 query heads span two kv heads; with one
  kv head on (2, 2), 3 rows (the batch spills onto the sequence);
* Case D: internvl2-1b with a 509-row vocabulary and 6 / 2 heads of 32 on
  (1, 4), and 3 / 1 heads of 32 on (2, 2) with 3 rows and 2 rows (on
  (2, 2) 6 / 2 heads would be Case H);
* seamless with the 509-row vocabulary (its table on D, the cross- and
  encoder attention on heads) on (1, 4), with 2 kv heads (Case Q) on
  (1, 4), with 6 / 2 heads of 32 (Case D) on (1, 4) and 3 / 1 on (2, 2).

One spawn per mesh (``tests/_torch_mesh_ranks.py:fallback_rank``), a
greedy stream of 6 tokens from each case's prompts.  Held on every rank:
the cuts; each leaf's bytes equal to JAX's ``param_spec`` (``fsdp=False``)
on the same mesh; the stream bit-equal to JAX's (jitted decode steps); the
prefill's and every decode step's logits within 1e-4 of max|logit| of
JAX's ``forward``, and every rank's identical; each decode step's
all_reduces equal to ``test_torch_mesh_families.
all_reduces_per_decode_step`` and to ``chip_smoke.
_all_reduces_per_decode_step``; the cache block after the last step, leaf
for leaf, within 1e-4 of max|value| of the same block of JAX's cache.  And
``shard_params`` raises NotImplementedError for an attention cut the
layer code does not run.
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
from repro.serving.engine import seed_cache as jseed_cache  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from test_torch_mesh_families import all_reduces_per_decode_step  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LLAMA, VLM, AUDIO = "llama3.2-1b", "internvl2-1b", "seamless-m4t-medium"
LOGIT_TOL = 1e-4        # of max|logit|
CACHE_TOL = 1e-4        # of max|value| of each leaf
PROMPT, NEW = 8, 6
ODD_VOCAB = 509
Q_SPAN = {"num_heads": 12, "num_kv_heads": 6, "head_dim": 16}
D_14 = {"num_heads": 6, "num_kv_heads": 2, "head_dim": 32,
        "vocab_size": ODD_VOCAB}
D_22 = {"num_heads": 3, "num_kv_heads": 1, "head_dim": 32,
        "vocab_size": ODD_VOCAB}

# (name, arch, replace, mesh, rows, the attention's cut, the tables' cut)
CASES = [
    ("llama-q", LLAMA, {"num_kv_heads": 2}, (1, 4), 2, "q", "vocab"),
    ("llama-q-span", LLAMA, Q_SPAN, (1, 4), 2, "q", "vocab"),
    ("vlm-d", VLM, D_14, (1, 4), 2, "d", "d"),
    ("audio-vocab", AUDIO, {"vocab_size": ODD_VOCAB}, (1, 4), 2, "heads", "d"),
    ("audio-q", AUDIO, {"num_kv_heads": 2, "vocab_size": ODD_VOCAB}, (1, 4),
     2, "q", "d"),
    ("audio-d", AUDIO, D_14, (1, 4), 2, "d", "d"),
    ("llama-q22", LLAMA, {"num_kv_heads": 1}, (2, 2), 3, "q", "vocab"),
    ("vlm-d22-spill", VLM, D_22, (2, 2), 3, "d", "d"),
    ("vlm-d22", VLM, D_22, (2, 2), 2, "d", "d"),
    ("audio-d22", AUDIO, D_22, (2, 2), 2, "d", "d"),
]
MESHES = sorted({c[3] for c in CASES})


def jcfg_of(arch, replace):
    return dataclasses.replace(jreduced(jget_config(arch)), **replace)


def _jax_case(i, name, arch, replace, B):
    """JAX's params (seed i), the inputs, and off the mesh a greedy stream
    of NEW tokens: the prefill's and each decode step's logits and the
    cache after the last step."""
    jcfg = jcfg_of(arch, replace)
    jp = jM.init_params(jcfg, jax.random.PRNGKey(i))
    rng = np.random.default_rng(40 + i)
    prompts = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    frontend = None
    if jcfg.frontend:
        frontend = rng.standard_normal((B, jcfg.frontend_tokens,
                                        jcfg.frontend_dim)).astype(np.float32)
    rows = PROMPT + (jcfg.frontend_tokens if jcfg.family == "vlm" else 0)
    max_len = rows + 8
    batch = {"tokens": jnp.asarray(prompts)}
    if frontend is not None:
        batch["frontend"] = jnp.asarray(frontend)
    pre = jM.forward(jp, jcfg, batch, mode="prefill")
    cache = jseed_cache(jcfg, jM.init_cache(jcfg, B, max_len,
                                            dtype=jnp.float32),
                        pre.cache, rows)

    @jax.jit
    def decode(cache, tok, index):
        o = jM.forward(jp, jcfg, {"token": tok[:, None], "cache": cache,
                                  "cache_index": index}, mode="decode")
        return o.logits[:, 0], o.cache

    logits = [np.asarray(pre.logits[:, -1])]
    stream = [np.argmax(logits[-1], -1).astype(np.int32)]
    for s in range(NEW - 1):
        lg, cache = decode(cache, jnp.asarray(stream[-1]),
                           jnp.int32(rows + s))
        logits.append(np.asarray(lg))
        stream.append(np.argmax(logits[-1], -1).astype(np.int32))
    params = jax.tree.map(np.asarray, jp)
    return dict(
        rank_case=dict(kind=name, arch=arch, replace=replace, params=params,
                       prompts=prompts, frontend=frontend, max_len=max_len,
                       new=NEW, cache=jax.tree.map(np.asarray, cache)),
        logits=logits, stream=np.stack(stream, 1), params=params)


@pytest.fixture(scope="module")
def refs():
    return {c[0]: _jax_case(i, c[0], c[1], c[2], c[4])
            for i, c in enumerate(CASES)}


@pytest.fixture(scope="module")
def runs(refs):
    """{case name: [each rank's result]}, one spawn a mesh."""
    out = {}
    for shape in MESHES:
        names = [c[0] for c in CASES if c[3] == shape]
        res = run_ranks(ranks.fallback_rank, math.prod(shape), shape,
                        [refs[n]["rank_case"] for n in names], threads=1)
        for j, n in enumerate(names):
            out[n] = [r[j] for r in res]
    return out


def _case(name):
    return next(c for c in CASES if c[0] == name)


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("name", NAMES)
def test_cuts_and_param_bytes_match_jax_spec(runs, refs, name):
    """The cuts the models read, and every rank's bytes of every leaf
    equal to JAX's ``param_spec`` on the same mesh (serving: no FSDP)."""
    _, arch, replace, shape, _, attn, table = _case(name)
    jcfg = jcfg_of(arch, replace)
    sizes = {"data": shape[0], "model": shape[1]}
    flat, _ = jax.tree_util.tree_flatten_with_path(refs[name]["params"])
    want = {}
    for path, a in flat:
        names = tuple(str(getattr(k, "key", k)) for k in path)
        spec = jparam_spec(path, a.shape, model_size=shape[1],
                           data_size=shape[0], stacked=tmesh._stacked(names),
                           fsdp=False)
        n = a.size * a.dtype.itemsize
        for e in spec:
            n //= sizes[e] if e else 1
        want["/".join(names)] = n
    for r in runs[name]:
        assert r["cuts"]["attn"] == attn and r["cuts"]["embed"] == table
        assert r["cuts"]["head"] == table
        assert r["cuts"]["frontend"] == ("d" if jcfg.frontend else None)
        assert r["param_bytes"] == want


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax_forward(runs, refs, name):
    """The prefill and each greedy decode step: every rank's logits within
    1e-4 of max|logit| of JAX's off-mesh forward, the ranks' identical."""
    want = refs[name]["logits"]
    scale = max(float(np.abs(w).max()) for w in want)
    got = [r["logits"] for r in runs[name]]
    for rank_logits in got:
        for g, w in zip(rank_logits, want):
            np.testing.assert_allclose(g, w, atol=LOGIT_TOL * scale, rtol=0)
    for other in got[1:]:
        for g0, g in zip(got[0], other):
            np.testing.assert_array_equal(g0, g)


@pytest.mark.parametrize("name", NAMES)
def test_decode_all_reduces_match_the_formula(runs, name):
    _, arch, replace, shape, B, attn, _ = _case(name)
    cfg = ranks.make_cfg(arch, **replace)
    want = all_reduces_per_decode_step(cfg, shape, B)
    max_len = PROMPT + M.frontend_offset(cfg) + 8
    assert chip_smoke._all_reduces_per_decode_step(cfg, shape, B,
                                                   max_len) == want
    for r in runs[name]:
        assert r["calls"] == [want] * (NEW - 1), (r["calls"], want)
        # "q" and "d" leave the kv heads whole: the cache's sequence is cut
        assert r["seq"] == (attn != "heads" or B % shape[0] != 0)


@pytest.mark.parametrize("name", NAMES)
def test_cache_blocks_match_jax(runs, name):
    """Every leaf of each rank's cache block after the decode steps within
    1e-4 of max|value| of the same block of JAX's cache."""
    for r in runs[name]:
        got, want = r["cache"], r["cache_want"]
        assert got.keys() == want.keys()
        for sub in want:
            for k, w in want[sub].items():
                assert got[sub][k].shape == w.shape, (sub, k)
                scale = max(float(np.abs(w).max()), 1e-30)
                np.testing.assert_allclose(got[sub][k], w, rtol=0,
                                           atol=CACHE_TOL * scale,
                                           err_msg=f"{sub}/{k}")


@pytest.mark.parametrize("name", NAMES)
def test_greedy_streams_bit_equal(runs, refs, name):
    for r in runs[name]:
        np.testing.assert_array_equal(r["stream"], refs[name]["stream"])


def test_unimplemented_attention_cut_raises():
    """4 heads of 6 over d_model 250 on an axis of 3: the axis divides
    neither the heads nor d_model, so ``param_spec`` falls back to
    head_dim, which no layer code runs: ``shard_params`` and
    ``model_cuts`` raise NotImplementedError naming the leaf.  An axis of
    7 (dividing nothing: every projection whole) and of 8 (Case D) run."""
    cfg = ranks.make_cfg(LLAMA, num_heads=4, num_kv_heads=4, head_dim=6,
                         d_model=250, d_ff=510, vocab_size=510)
    full = M.init_params(cfg, 0, device="meta")
    mesh = tmesh.Mesh(np.arange(3).reshape(1, 3), ("data", "model"),
                      groups=False)
    with pytest.raises(NotImplementedError, match="blocks/attn"):
        tmesh.shard_params(full, mesh)
    with pytest.raises(NotImplementedError, match="blocks/attn"):
        tmesh.model_cuts(cfg, 3)
    # whole everywhere (an axis of 7 divides nothing) and Case D run
    assert tmesh.model_cuts(ranks.make_cfg(LLAMA), 7).attn is None
    assert tmesh.model_cuts(ranks.make_cfg(LLAMA), 8).attn == "d"


def test_production_meshes_never_raise():
    """At the 10 configs on (16, 16) and (2, 16, 16) (and reduced() on
    (2, 2)), with and without FSDP, every cut is one the layer code runs:
    ``model_cuts`` and ``train_layout`` raise nowhere."""
    from repro_torch.configs.base import get_config, mesh_configs, reduced
    for arch in mesh_configs():
        for cfg, m in ((get_config(arch), 16), (reduced(get_config(arch)), 2)):
            cuts = tmesh.model_cuts(cfg, m)
            assert cuts.attn in (None, "heads", "q", "d"), (arch, cuts)
        full = M.init_params(get_config(arch), 0, device="meta")
        for shape, axes in (((16, 16), ("data", "model")),
                            ((2, 16, 16), ("pod", "data", "model"))):
            mesh = tmesh.Mesh(np.arange(math.prod(shape)).reshape(shape),
                              axes, view=True)
            for fsdp in (True, False):
                tmesh.train_layout(full, mesh, fsdp=fsdp)


def test_model_cuts_not_counted_by_measure():
    """The first forward on a mesh makes the config's abstract param tree
    (``model_cuts``) outside any dispatch mode: a counted program that
    reaches it first records the same flops, bytes and temporaries as one
    that finds it cached."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    cfg = ranks.make_cfg(VLM, **D_14)
    view = tmesh.Mesh(np.arange(4).reshape(1, 4), ("data", "model"),
                      view=True)
    shape = InputShape("t", 32, 4, "train")
    tmesh.model_cuts.cache_clear()
    first = dryrun.trace_one(cfg, shape, view)
    again = dryrun.trace_one(cfg, shape, view)
    for key in ("flops", "bytes_accessed", "temp_size_in_bytes"):
        assert first[key] == again[key], key
