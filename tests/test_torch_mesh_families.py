"""The SSM, hybrid, vlm and audio families on a mesh of gloo ranks,
against the JAX package's off-mesh functions (JAX's sharded paths fail on
the local jax, and GSPMD's per-rank layouts are a compiler's choice, so
the outputs are compared).

In one process: ``shard_params`` on every leaf of the four families at
``reduced()`` size, on each rank of a "model" axis of 2 and 4: each
rank's slices reassemble to the whole leaf -- ``in_proj``'s u and z
halves each from its channel slices, Mamba-2's ``bc_proj`` from its
d_inner rows, its per-head leaves and ``dt_proj`` from their heads --
and ``frontend_proj`` is cut on its D columns (JAX's
``P(None, "model")``), the norms stay whole.

Across ranks (``tests/_torch_mesh_ranks.py``; one spawn per mesh): one
Mamba-1 and one Mamba-2 mixer on (1, 2) and (1, 4), prefill and a decode
step, output and states within 1e-5 of JAX's ``mamba_apply``; prefill and
3 teacher-forced decode steps of falcon-mamba, zamba2, internvl2-1b and
seamless (with their frontends) on (1, 2) and (2, 2) -- 2 rows, which
split over "data", and 3, which do not -- within 1e-4 of max|logit| of
JAX's ``forward``, every rank holding the same logits, and the all_reduces
each decode step runs equal to :func:`all_reduces_per_decode_step`;
``seed_cache``, ``write_slot_cache`` and ``splice_slot_caches`` on every
rank's block bit-equal to the same block of the one-rank ops' result, for
the Mamba-1 (4-dim) and Mamba-2 (5-dim) states, the hybrid's shared K/V,
the vlm's K/V and the audio decoder's self and cross K/V, with 4 slots
(the batch splits over "data") and 3 (it does not).
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
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.engine import seed_cache as jseed_cache  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-2.7b"
VLM, AUDIO = "internvl2-1b", "seamless-m4t-medium"
FAMILIES = [FALCON, ZAMBA, VLM, AUDIO]
OP_TOL = 1e-5        # one mixer: its rank-split partial sums, f32
LOGIT_TOL = 1e-4     # of max|logit|


# ---------------------------------------------------------------------------
# shard_params, in one process
# ---------------------------------------------------------------------------
def _rank_mesh(m: int, i: int):
    """Rank i's view of a (1, m) mesh that only states a shape."""
    mesh = tmesh.Mesh(np.arange(m).reshape(1, m), ("data", "model"),
                      groups=False)
    mesh.rank, mesh.coords = i, (0, i)
    return mesh


def _leaves(tree, names=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, names + (k,))
        else:
            yield names + (k,), v


def _get(tree, names):
    for n in names:
        tree = tree[n]
    return tree


def _reassemble(names, parts, full):
    """The whole leaf from its ranks' slices: ``in_proj`` half by half,
    any other leaf along the one dim its slices are cut on."""
    if names[-1] == "in_proj":
        halves = [p.chunk(2, dim=-1) for p in parts]
        return torch.cat([torch.cat([h[0] for h in halves], dim=-1),
                          torch.cat([h[1] for h in halves], dim=-1)], dim=-1)
    cut = [d for d in range(full.dim()) if parts[0].shape[d] != full.shape[d]]
    assert len(cut) == 1, (names, parts[0].shape, full.shape)
    return torch.cat(parts, dim=cut[0])


# the dim each split Mamba leaf is cut on, from the end (Mamba-1 / Mamba-2)
MAMBA_CUTS = {
    1: {"in_proj": -1, "conv_w": -1, "conv_b": -1, "x_proj": -2,
        "dt_proj": -1, "dt_bias": -1, "A_log": -2, "D": -1, "out_proj": -2},
    2: {"in_proj": -1, "conv_w": -1, "conv_b": -1, "bc_proj": -2,
        "dt_proj": -1, "dt_bias": -1, "A_log": -1, "D": -1, "out_proj": -2},
}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_params_reassembles_every_leaf(arch, m):
    cfg = reduced(get_config(arch))
    full = M.init_params(cfg, 0, device="cpu")
    parts = [tmesh.shard_params(full, _rank_mesh(m, i)) for i in range(m)]
    split = 0
    for names, leaf in _leaves(full):
        got = [_get(p, names) for p in parts]
        if all(g.shape == leaf.shape for g in got):
            # whole on every rank: the same tensor
            for g in got:
                torch.testing.assert_close(g, leaf, rtol=0, atol=0)
            assert names[-1] not in ("in_proj", "out_proj", "w_down", "wq",
                                     "wk", "wv", "wo", "table",
                                     "frontend_proj"), names
            continue
        split += 1
        assert names[-1] not in ("router", "scale", "bias"), names
        if names[-1] == "frontend_proj":     # [F_in, D] on its D columns
            assert got[0].shape == (leaf.shape[0], leaf.shape[1] // m), names
        torch.testing.assert_close(_reassemble(names, got, leaf), leaf,
                                   rtol=0, atol=0)
        if "mamba" in names:
            dim = MAMBA_CUTS[cfg.mamba_version][names[-1]]
            assert got[0].shape[dim] * m == leaf.shape[dim], names
            # the split widths are the rank's channels or heads
            di = cfg.d_inner // m
            heads = cfg.d_inner // cfg.ssm_head_dim // m
            want = {"in_proj": 2 * di}.get(names[-1], di)
            if cfg.mamba_version == 2 and names[-1] in ("dt_proj", "dt_bias",
                                                        "A_log", "D"):
                want = heads
            assert got[0].shape[dim] == want, (names, got[0].shape)
    assert split


# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------
def _mamba_cases():
    rng = np.random.default_rng(31)
    cases = []
    for arch in (FALCON, ZAMBA):
        jcfg = jreduced(jget_config(arch))
        jp = jM.init_params(jcfg, jax.random.PRNGKey(3))
        stack = jp["blocks"]["mamba"] if arch == FALCON \
            else jp["blocks"]["backbone"]["mamba"]
        layer = jax.tree.map(lambda a: np.asarray(a[0]), stack)
        x = (rng.standard_normal((2, 8, jcfg.d_model)) * 0.5).astype(np.float32)
        x1 = (rng.standard_normal((2, 1, jcfg.d_model)) * 0.5).astype(np.float32)
        cases.append(dict(kind="mamba", arch=arch, params=layer, x=x, x1=x1))
    return cases


def _frontend(cfg, rng, B):
    if not cfg.frontend:
        return None
    return rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)
                               ).astype(np.float32)


def _logits_cases():
    rng = np.random.default_rng(32)
    cases = []
    for arch in FAMILIES:
        jcfg = jreduced(jget_config(arch))
        params = jax.tree.map(np.asarray,
                              jM.init_params(jcfg, jax.random.PRNGKey(4)))
        for B in (2, 3):
            cases.append(dict(
                kind="family_logits", arch=arch, params=params,
                prompts=rng.integers(0, jcfg.vocab_size, (B, 8)).astype(np.int32),
                frontend=_frontend(jcfg, rng, B),
                tokens=rng.integers(0, jcfg.vocab_size, (3, B)).astype(np.int32),
                max_len=8 + jcfg.frontend_tokens * (arch == VLM) + 8))
    return cases


def _cache_cases():
    return [dict(kind="family_cache", arch=arch, slots=B, max_len=16,
                 prefill=6, ids=ids, slot=B - 1, seed=33)
            for arch in FAMILIES for B, ids in ((4, [1, 3, 0]), (3, [2, 0, 0]))]


GROUPS = ("mamba", "logits", "cache")


@pytest.fixture(scope="module")
def cases():
    return {"mamba": _mamba_cases(), "logits": _logits_cases(),
            "cache": _cache_cases()}


@pytest.fixture(scope="module")
def runs(cases):
    """The mixers on (1, 2) and (1, 4); the logits and cache cases on
    (1, 2) and (2, 2): one spawn a mesh."""
    plan = {(1, 2): GROUPS, (1, 4): ("mamba",), (2, 2): ("logits", "cache")}
    out = {}
    for shape, groups in plan.items():
        flat = [c for g in groups for c in cases[g]]
        res = run_ranks(ranks.family_rank, int(np.prod(shape)), shape, flat,
                        threads=1)
        per_rank = []
        for r in res:
            split, i = {}, 0
            for g in groups:
                split[g], i = r[i:i + len(cases[g])], i + len(cases[g])
            per_rank.append(split)
        out[shape] = per_rank
    return out


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_mamba_apply_on_rank_channels_matches_jax(runs, cases, arch, shape):
    """Each rank's output (all_reduced: the whole of it) and its channels
    of the states, prefill and one decode step, within 1e-5 of JAX's
    off-mesh ``mamba_apply``."""
    i = [c["arch"] for c in cases["mamba"]].index(arch)
    case = cases["mamba"][i]
    jcfg = jreduced(jget_config(arch))
    jp = jax.tree.map(jnp.asarray, case["params"])
    y, state = jssm.mamba_apply(jp, jnp.asarray(case["x"]), jcfg, mode="full")
    y1, state1 = jssm.mamba_apply(jp, jnp.asarray(case["x1"]), jcfg,
                                  state=state, mode="decode")
    res = [r["mamba"][i] for r in runs[shape]]
    m = shape[1]
    assert [r["mi"] for r in res] == list(range(m))
    assert all(r["di"] == jcfg.d_inner // m for r in res)
    for key, want in (("y", y), ("y1", y1)):
        for r in res:
            np.testing.assert_allclose(r[key], np.asarray(want), atol=OP_TOL,
                                       rtol=OP_TOL)
    # the states: conv [B, W-1, di] on its last dim, SSM [B, di, N] or
    # [B, H, P, N] on dim 1, each rank one slice
    for (conv_key, h_key), (conv, h) in ((("conv", "h"), state),
                                         (("conv1", "h1"), state1)):
        np.testing.assert_allclose(
            np.concatenate([r[conv_key] for r in res], axis=-1),
            np.asarray(conv), atol=OP_TOL, rtol=OP_TOL)
        np.testing.assert_allclose(
            np.concatenate([r[h_key] for r in res], axis=1), np.asarray(h),
            atol=OP_TOL, rtol=OP_TOL)


def _jax_logits(case):
    jcfg = jreduced(jget_config(case["arch"]))
    jp = jax.tree.map(jnp.asarray, case["params"])
    batch = {"tokens": jnp.asarray(case["prompts"])}
    if case["frontend"] is not None:
        batch["frontend"] = jnp.asarray(case["frontend"])
    B, P = case["prompts"].shape
    rows = P + (jcfg.frontend_tokens if jcfg.family == "vlm" else 0)
    out = jM.forward(jp, jcfg, batch, mode="prefill")
    want = [np.asarray(out.logits[:, -1])]
    cache = jseed_cache(jcfg, jM.init_cache(jcfg, B, case["max_len"],
                                            dtype=jnp.float32),
                        out.cache, rows)
    for s, tok in enumerate(case["tokens"]):
        o = jM.forward(jp, jcfg, {"token": jnp.asarray(tok)[:, None],
                                  "cache": cache,
                                  "cache_index": jnp.int32(rows + s)},
                       mode="decode")
        cache = o.cache
        want.append(np.asarray(o.logits[:, 0]))
    return want


@pytest.fixture(scope="module")
def jax_logits(cases):
    return [_jax_logits(c) for c in cases["logits"]]


def _logit_index(cases, arch, B):
    return next(i for i, c in enumerate(cases["logits"])
                if c["arch"] == arch and c["prompts"].shape[0] == B)


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_logits_on_mesh_match_jax_forward(runs, cases, jax_logits,
                                                 arch, shape, B):
    """Prefill and 3 decode steps: every rank's whole-batch logits within
    1e-4 of max|logit| of JAX's off-mesh forward, and the ranks' logits
    identical."""
    i = _logit_index(cases, arch, B)
    want = jax_logits[i]
    scale = max(float(np.abs(w).max()) for w in want)
    got = [r["logits"][i]["logits"] for r in runs[shape]]
    for rank_logits in got:
        for g, w in zip(rank_logits, want):
            np.testing.assert_allclose(g, w, atol=LOGIT_TOL * scale, rtol=0)
    for other in got[1:]:
        for g0, g in zip(got[0], other):
            np.testing.assert_array_equal(g0, g)


def _divides(n, m):
    return n % m == 0 and n >= m


def attn_cut(cfg, m):
    """The attention's cut over a "model" axis of ``m`` as JAX's
    ``param_spec`` places it, from the head counts: "heads" when the kv
    heads divide, "q" when only the query heads do (wk/wv on their D
    rows), else "d" (every projection on D, which the axis divides at these
    configs); None without attention or without the axis."""
    if m == 1 or not cfg.num_heads:
        return None
    if _divides(cfg.num_kv_heads, m):
        return "heads"
    return "q" if _divides(cfg.num_heads, m) else "d"


def table_cut(cfg, m):
    """A vocab table's cut: its rows when the axis divides the vocabulary,
    else its D columns when it divides d_model, else whole."""
    if m == 1:
        return None
    if _divides(cfg.vocab_size, m):
        return "vocab"
    return "d" if _divides(cfg.d_model, m) else None


def all_reduces_per_decode_step(cfg, mesh_shape, B):
    """The all_reduces one decode step runs on a rank of a (data, model)
    mesh whose "model" axis divides the mixer's channels and the MLP width
    (``PERF.md`` §6 writes the same count): the embedding and the LM head
    when "model" cuts their table (rows or D columns), one more gather of
    the batch rows when the batch splits over a "data" axis > 1; two a
    Mamba layer (x_proj / dt+B/C, out_proj) and a Mamba-2 layer one more
    (its ``dt_proj``'s gather: it is held on its heads); a self-attention
    sublayer, by
    its cut: "heads" one (its output projection), "q" two (k and v with
    the query heads' gather; the output projection), "d" two (q, k and v;
    the output's D gather), two more when its cache's sequence is sharded (the
    lse merge: the batch spills onto it, or the kv heads do not divide); a
    cross-attention sublayer one ("heads") or two; an MLP one."""
    data, model = mesh_shape
    if model == 1:
        return 0
    b_split = B % data == 0 and B >= data
    cut = attn_cut(cfg, model)
    seq = not b_split or cut in ("q", "d")
    attn = {"heads": 1, "q": 2, "d": 2}.get(cut, 0) + (2 if seq else 0)
    cross = {"heads": 1, "q": 2, "d": 2}.get(cut, 0)
    n = (2 if table_cut(cfg, model) else 0) \
        + (1 if b_split and data > 1 else 0)
    if cfg.family == "ssm":
        return n + 2 * cfg.num_layers
    if cfg.family == "hybrid":
        return n + (2 + (cfg.mamba_version == 2)) * cfg.num_layers \
            + (cfg.num_layers // cfg.hybrid_attn_every) * (attn + 1)
    if cfg.family == "audio":
        return n + cfg.num_layers * (attn + cross + 1)
    return n + cfg.num_layers * (attn + 1)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_all_reduces_per_decode_step_match_the_formula(runs, cases, arch, shape):
    for B in (2, 3):
        i = _logit_index(cases, arch, B)
        want = all_reduces_per_decode_step(reduced(get_config(arch)), shape, B)
        for r in runs[shape]:
            res = r["logits"][i]
            assert res["all_reduce_calls"] == [want] * 3, (B, res)
            assert res["b_sharded"] == (B % shape[0] == 0)


def test_full_width_all_reduce_counts():
    """The counts ``chip_smoke.py``'s mesh phases hold at full width:
    falcon-mamba on (1, 2) 130 a step, zamba2 182 (128 before its Mamba-2
    ``dt_proj`` went on its heads: one gather a layer), internvl2-1b on (2, 2)
    with 3 slots 98 (its 151655-row vocab goes on D: the embedding's
    gather and the logits' sum), seamless 38; and chip_smoke's own
    formula agrees."""
    want = {(FALCON, (1, 2), 4): 130, (ZAMBA, (1, 2), 4): 182,
            (VLM, (2, 2), 3): 98, (AUDIO, (1, 2), 4): 38}
    for (arch, shape, B), n in want.items():
        assert all_reduces_per_decode_step(get_config(arch), shape, B) == n
        assert chip_smoke._all_reduces_per_decode_step(get_config(arch),
                                                       shape, B) == n


@pytest.mark.parametrize("slots", [4, 3])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_writes_on_rank_blocks_bit_equal(runs, cases, arch, shape, slots):
    """seed_cache, write_slot_cache and splice_slot_caches: every leaf of
    every rank's block bit-equal to that block of the one-rank result, and
    the block init_cache allocates is the one the ops write."""
    i = next(j for j, c in enumerate(cases["cache"])
             if c["arch"] == arch and c["slots"] == slots)
    for r in runs[shape]:
        res = r["cache"][i]
        assert res["shapes"] == res["cut_shapes"]
        assert res["b_sharded"] == (slots % shape[0] == 0)
        for op in ("seed", "slot_write", "splice"):
            assert res[op] and max(res[op]) == 0.0, (op, res[op])


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_mode_on_a_mesh_still_raises(arch):
    """Training across ranks runs the rank's block of the train step
    (``tests/test_torch_mesh_train*.py``): ``forward(mode="train")`` under
    a mesh without that block (``shard=``) raises."""
    from repro_torch.models import sharding
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    if cfg.frontend:
        batch["frontend"] = torch.zeros((1, cfg.frontend_tokens,
                                         cfg.frontend_dim))
    with sharding.activation_sharding(_rank_mesh(2, 0)), \
            pytest.raises(ValueError, match="train on a mesh takes shard="):
        M.forward(params, cfg, batch, mode="train")
