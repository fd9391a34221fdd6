"""The port's mesh layer against the JAX package's rules and off-mesh
functions.

Pure rules, in one process: ``mesh_axis_sizes``, ``seq_shard_layout``,
``param_spec`` / ``params_specs`` (every leaf of every ``reduced()`` config,
model and data sizes 1, 2 and 4), ``data_specs``, ``padded_quota_batch``,
``WorkloadCost`` / ``analytic_profile`` and the input shapes, each identical
to JAX's (JAX's placement functions are called on an ``AbstractMesh``).

Across ranks, on (1, 2) and (2, 2) gloo meshes spawned once per module
(``tests/_torch_mesh_ranks.py`` holds what each rank runs): MoE
expert-parallel and ``f_parallel`` within 1e-5 of JAX's ``_moe_global``
(aux within 1e-6; on the (2, 2) mesh the batch is split, and the aux is the
mean of the shards' ``_moe_global`` aux, as the shard_map's pmean makes
it); the sequence-sharded ``cache_update`` and ``splice_blocks`` gathered
from every rank bit-equal to JAX's plain ones; decode over sequence shards
with the lse merge within 1e-5 of ``decode_attention_ref`` (empty windows
0); head-parallel logits after prefill and 4 decode steps within 1e-4 of
JAX's off-mesh ``forward``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import list_configs as jlist_configs  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.core import offload as joffload  # noqa: E402
from repro.core import profiler as jprofiler  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import offload, profiler  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import sharding  # noqa: E402

MESH_SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 2), (2, 4), (1, 4)]
MOE_ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b", "mixtral-8x22b"]


# ---------------------------------------------------------------------------
# pure rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_axes", [1, 2, 3])
def test_mesh_axis_sizes_match_jax(n_axes):
    for n in range(1, 65):
        assert offload.mesh_axis_sizes(n, n_axes) \
            == joffload.mesh_axis_sizes(n, n_axes), n
    sizes = (2,) * n_axes
    assert offload.mesh_axis_sizes(2 ** n_axes, n_axes, sizes) == sizes
    for bad in [(3,) * n_axes, (2,) * (n_axes + 1)]:
        with pytest.raises(ValueError):
            offload.mesh_axis_sizes(2 ** n_axes, n_axes, bad)
        with pytest.raises(ValueError):
            joffload.mesh_axis_sizes(2 ** n_axes, n_axes, bad)


def _abstract(shape, axes=("data", "model")):
    return AbstractMesh(tuple(shape), tuple(axes))


def _port_mesh(shape, axes=("data", "model")):
    return tmesh.Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)


@pytest.mark.parametrize("shape,axes", [(s, ("data", "model")) for s in MESH_SHAPES]
                         + [((2, 2, 2), ("pod", "data", "model"))])
def test_seq_shard_layout_matches_jax(shape, axes):
    jm, tm = _abstract(shape, axes), _port_mesh(shape, axes)
    for B in range(1, 9):
        for S in (1, 6, 8, 32, 48):
            for hkv in (1, 2, 3, 4, 8):
                want = jsharding.seq_shard_layout(jm, B, S, hkv)
                got = sharding.seq_shard_layout(tm, B, S, hkv)
                assert (got is None) == (want is None), (B, S, hkv)
                if want is not None:
                    assert tuple(got) == tuple(want), (B, S, hkv)


@pytest.mark.parametrize("arch", jlist_configs())
def test_param_spec_matches_jax_every_leaf(arch):
    jcfg = jreduced(jget_config(arch))
    abs_params = jax.eval_shape(lambda: jM.init_params(jcfg, jax.random.PRNGKey(0)))
    for model_size in (1, 2, 4):
        for data_size in (1, 2, 4):
            jm = _abstract((data_size, model_size))
            tm = _port_mesh((data_size, model_size))
            for fsdp in (True, False):
                want = jmesh.params_shardings(abs_params, jm, fsdp=fsdp)
                got = tmesh.params_specs(abs_params, tm, fsdp=fsdp)
                for path, sh in jax.tree_util.tree_leaves_with_path(want):
                    node = got
                    for p in path:
                        node = node[getattr(p, "key", getattr(p, "idx", None))]
                    assert node == tuple(sh.spec), (path, model_size, data_size)
                # the rule itself, leaf by leaf, on the unstacked view too
                for path, leaf in jax.tree_util.tree_leaves_with_path(abs_params):
                    names = jmesh._path_names(path)
                    for stacked in (True, False):
                        kw = dict(model_size=model_size, data_size=data_size,
                                  stacked=stacked, fsdp=fsdp)
                        assert tmesh.param_spec(names, leaf.shape, **kw) == \
                            tuple(jmesh.param_spec(path, leaf.shape, **kw))
    jm = _abstract((2, 2, 2), ("pod", "data", "model"))
    tm = _port_mesh((2, 2, 2), ("pod", "data", "model"))
    want = jmesh.params_shardings(abs_params, jm)
    got = tmesh.params_specs(abs_params, tm)
    assert [tuple(s.spec) for s in jax.tree.leaves(want)] == \
        [s for s in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 2), (2, 1)])
def test_data_specs_match_jax(shape):
    batch = {"tokens": jax.ShapeDtypeStruct((4, 16), np.int32),
             "odd": jax.ShapeDtypeStruct((3, 16), np.int32),
             "frontend": jax.ShapeDtypeStruct((1, 32, 8), np.float32),
             "cache": {"k": jax.ShapeDtypeStruct((2, 4, 32, 2, 8), np.float32),
                       "v1": jax.ShapeDtypeStruct((2, 1, 32, 1, 8), np.float32),
                       "v3": jax.ShapeDtypeStruct((2, 3, 48, 4, 8), np.float32)},
             "ssm": jax.ShapeDtypeStruct((2, 4, 16, 4), np.float32),
             "scalar": jax.ShapeDtypeStruct((), np.int32)}
    want = jmesh.data_shardings(batch, _abstract(shape))
    got = tmesh.data_specs(batch, _port_mesh(shape))
    for path, sh in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for p in path:
            node = node[p.key]
        assert node == tuple(sh.spec), path
    assert tmesh.batch_axes(_port_mesh(shape)) == jmesh.batch_axes(_abstract(shape))


@pytest.mark.parametrize("r", [0.0, 0.3, 0.5, 0.71, 1.0])
def test_padded_quota_batch_matches_jax(r):
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 100, (7, 5)).astype(np.int32),
             "x": rng.standard_normal((7, 3, 2)).astype(np.float32)}
    jtree, jmask = joffload.padded_quota_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, r)
    ttree, tmask = offload.padded_quota_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, r)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for k in batch:
        np.testing.assert_array_equal(ttree[k].numpy(), np.asarray(jtree[k]))


def test_workload_cost_and_analytic_profile_match_jax():
    rng = np.random.default_rng(11)
    rs = [0.0, 0.2, 0.5, 0.9, 1.0]
    for _ in range(20):
        vals = rng.uniform(1e6, 1e15, 4)
        jc = jprofiler.WorkloadCost("w", *vals)
        tc = profiler.WorkloadCost("w", *vals)
        frac = float(rng.uniform(0, 1))
        assert dataclasses.astuple(tc.scaled(frac)) \
            == dataclasses.astuple(jc.scaled(frac))
        chips = int(rng.integers(1, 5))
        busy = float(rng.uniform(0, 0.5))
        # every field given: the two packages' defaults are their chips'
        dev = dict(chips=chips, busy_factor=busy, peak_flops=1e14,
                   hbm_bw=1e12, link_bw=1e11, power_budget_w=300.0,
                   memory_bytes=1e10)
        jd = jprofiler.DeviceProfile("d", **dev)
        td = profiler.DeviceProfile("d", **dev)
        jp = jprofiler.analytic_profile(jd, jc, rs)
        tp = profiler.analytic_profile(td, tc, rs)
        for got, want in zip(tp.arrays(), jp.arrays()):
            np.testing.assert_allclose(got, want, rtol=1e-12)


def test_input_shapes_and_applicable_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in shapes.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.INPUT_SHAPES.items()}
    for name in jshapes.INPUT_SHAPES:
        assert dataclasses.astuple(shapes.get_shape(name)) \
            == dataclasses.astuple(jshapes.get_shape(name))
        for arch in jlist_configs():
            assert shapes.applicable(get_config(arch), shapes.get_shape(name)) \
                == jshapes.applicable(jget_config(arch), jshapes.get_shape(name))


def test_mesh_constructors():
    with pytest.raises(RuntimeError):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError):
        tmesh.make_production_mesh(multi_pod=True)
    smoke = tmesh.make_smoke_mesh()
    assert smoke.shape == {"data": 1, "model": 1} and smoke.size == 1
    assert smoke.axis_index("model") == 0 and smoke.group(("model",)) is None
    assert sharding.scaleout_mesh([0]).shape == {"data": 1, "model": 1}
    group = offload.NodeGroup("g", [torch.device("cpu")], profiler.JETSON_NANO,
                              ranks=list(range(12)))
    # a mesh that only states a shape (no process group): 12 ranks
    assert dict(group.mesh(("pod", "data", "model")).shape) == \
        {"pod": 3, "data": 2, "model": 2}
    assert dict(group.mesh(("data", "model"), (6, 2)).shape) == \
        {"data": 6, "model": 2}


def test_shard_params_slices_preferred_dims():
    """Rank 0 of a (1, 2) mesh: the attention heads (kv heads divide), the
    MLP width, the vocab, the experts and the router's experts (JAX's
    ``param_spec``; the MoE layer gathers it) are halved on the dims the
    model code reads; norms stay whole; with one kv head
    (Case Q: the axis divides the query heads only) the query heads and
    ``wo``'s are halved and ``wk``/``wv`` take half their D rows, every
    kv head."""
    mesh = _port_mesh((1, 2))
    for arch, hkv in (("llama3.2-1b", None), ("moonshot-v1-16b-a3b", None),
                      ("llama3.2-1b", 1)):
        cfg = reduced(get_config(arch))
        if hkv:
            cfg = dataclasses.replace(cfg, num_kv_heads=hkv)
        from repro_torch.models import model as M
        full = M.init_params(cfg, 0, device="cpu")
        part = tmesh.shard_params(full, mesh)
        attn = part["blocks"]["attn"]
        heads = cfg.num_heads // 2
        assert attn["wq"].shape[2] == heads and attn["wo"].shape[1] == heads
        for w in ("wk", "wv"):
            if hkv:
                assert attn[w].shape[1:] == (cfg.d_model // 2, hkv,
                                             cfg.head_dim)
                torch.testing.assert_close(
                    attn[w], full["blocks"]["attn"][w][:, :cfg.d_model // 2])
            else:
                assert attn[w].shape[1:] == (cfg.d_model,
                                             cfg.num_kv_heads // 2,
                                             cfg.head_dim)
        assert part["embed"]["table"].shape[0] == cfg.vocab_size // 2
        assert part["final_norm"]["scale"].shape == full["final_norm"]["scale"].shape
        if cfg.num_experts:
            moe = part["blocks"]["moe"]
            assert moe["w_gate"].shape[1] == cfg.num_experts // 2
            router = full["blocks"]["moe"]["router"]
            assert moe["router"].shape == (*router.shape[:2],
                                           cfg.num_experts // 2)
            torch.testing.assert_close(
                moe["router"], router[..., :cfg.num_experts // 2])
            assert moe["shared"]["w_down"].shape[1] == \
                cfg.d_ff * cfg.num_shared_experts // 2
        else:
            assert part["blocks"]["mlp"]["w_down"].shape[1] == cfg.d_ff // 2
        torch.testing.assert_close(attn["wq"],
                                   full["blocks"]["attn"]["wq"][:, :, :heads])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_local_dispatch_ffn_matches_jax_under_overflow(arch):
    """The shard body alone, at a capacity small enough to drop choices:
    the kept set and the sums equal JAX's ``_local_dispatch_ffn``."""
    from repro_torch.models import moe
    jcfg = jreduced(jget_config(arch))
    rng = np.random.default_rng(5)
    T, D, F, E = 64, jcfg.d_model, jcfg.d_ff, jcfg.num_experts
    xt = rng.standard_normal((T, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    logits = xt @ router
    cfg = reduced(get_config(arch))
    gates, ids, _, _ = moe.route(torch.from_numpy(xt), torch.from_numpy(router),
                                 cfg)
    for e0, E_loc in ((0, E), (0, E // 2), (E // 2, E // 2)):
        want = jmoe._local_dispatch_ffn(
            jnp.asarray(xt), jnp.asarray(logits), *(jnp.asarray(a[e0:e0 + E_loc])
                                                    for a in w),
            jcfg, e0, E_loc, 8)
        got = moe.local_dispatch_ffn(torch.from_numpy(xt), gates, ids,
                                     *(torch.from_numpy(a[e0:e0 + E_loc])
                                       for a in w), e0, E_loc, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------
def _moe_cases():
    cases, oracle = [], []
    rng = np.random.default_rng(21)
    for arch in MOE_ARCHS:
        jcfg = jreduced(jget_config(arch))
        jp = jM.init_params(jcfg, jax.random.PRNGKey(1))
        layer = jax.tree.map(lambda a: np.asarray(a[0]), jp["blocks"]["moe"])
        x = (rng.standard_normal((4, 8, jcfg.d_model)) * 0.5).astype(np.float32)
        for f_parallel in (False, True):
            cases.append(dict(kind="moe", arch=arch, params=layer, x=x,
                              f_parallel=f_parallel))
            oracle.append((jcfg, layer, x))
    return cases, oracle


def _cache_cases():
    rng = np.random.default_rng(22)
    cases = []
    for B, S, hkv in ((4, 16, 1), (4, 16, 2), (3, 16, 2), (3, 16, 1)):
        cache = rng.standard_normal((B, S, hkv, 8)).astype(np.float32)
        new = rng.standard_normal((B, 1, hkv, 8)).astype(np.float32)
        # every shard boundary of a 16-row cache cut 2, 4 or 8 ways, its
        # edges and one past the end
        for index in (np.array([0, 3, 4, 15][:B] + [7] * (B - 4), np.int32),
                      np.array([8, 7, 12, 16][:B], np.int32),
                      np.array(5, np.int32), np.array(15, np.int32)):
            cases.append(dict(kind="update", cache=cache, new=new, index=index))
        L = 2
        dst = rng.standard_normal((L, B, S, hkv, 8)).astype(np.float32)
        for P, ids in ((3, [1]), (6, [0, 2, 1]), (11, [B - 1, 0, 0]),
                       (16, [2])):
            src = rng.standard_normal((L, len(ids), P, hkv, 8)).astype(np.float32)
            cases.append(dict(kind="splice", dst=dst, src=src,
                              slot_ids=np.array(ids, np.int32)))
    return cases


def _decode_cases():
    rng = np.random.default_rng(23)
    cases = []
    for B, S, H, hkv in ((4, 16, 4, 1), (3, 16, 4, 2), (4, 32, 8, 2)):
        q = rng.standard_normal((B, 1, H, 8)).astype(np.float32)
        k = rng.standard_normal((B, S, hkv, 8)).astype(np.float32)
        v = rng.standard_normal((B, S, hkv, 8)).astype(np.float32)
        lens = np.array([S, 1, S // 2 + 1, 0][:B], np.int32)
        for window in (0, 3):
            cases.append(dict(kind="decode", q=q, k=k, v=v, cache_len=lens,
                              window=window))
    return cases


def _logits_cases():
    rng = np.random.default_rng(24)
    cases = []
    for arch in ("llama3.2-1b", "moonshot-v1-16b-a3b"):
        jcfg = jreduced(jget_config(arch))
        jp = jM.init_params(jcfg, jax.random.PRNGKey(2))
        cases.append(dict(
            kind="logits", arch=arch, params=jax.tree.map(np.asarray, jp),
            prompts=rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32),
            tokens=rng.integers(0, jcfg.vocab_size, (4, 2)).astype(np.int32),
            max_len=16))
    return cases


def _batch_case():
    rng = np.random.default_rng(25)
    return dict(kind="batch", tree={
        "tokens": rng.integers(0, 99, (4, 6)).astype(np.int32),
        "odd": rng.integers(0, 99, (3, 6)).astype(np.int32),
        "cache": rng.standard_normal((2, 4, 8, 1, 4)).astype(np.float32)})


@pytest.fixture(scope="module")
def cases():
    moe_cases, moe_oracle = _moe_cases()
    return {"moe": (moe_cases, moe_oracle), "cache": _cache_cases(),
            "decode": _decode_cases(), "batch": [_batch_case()],
            "logits": _logits_cases()}


GROUPS = ("moe", "cache", "decode", "batch", "logits")


@pytest.fixture(scope="module")
def runs(cases):
    """Every case on the (1, 2) and the (2, 2) mesh: one spawn each (the
    logits cases on (1, 2) only)."""
    out = {}
    for shape in ((1, 2), (2, 2)):
        groups = [cases[g][0] if g == "moe" else cases[g] for g in GROUPS]
        if shape != (1, 2):
            groups[-1] = []
        res = run_ranks(ranks.ops_rank, int(np.prod(shape)), shape,
                        [c for g in groups for c in g], threads=1)
        per_rank = []
        for r in res:
            split, i = {}, 0
            for name, g in zip(GROUPS, groups):
                split[name], i = r[i:i + len(g)], i + len(g)
            per_rank.append(split)
        out[shape] = per_rank
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_shard_batch_blocks_tile_the_batch(runs, cases, shape):
    """Each rank's block of a batch tree is its slice under
    ``data_specs``: the batch dim over "data" when it divides (3 rows do
    not), and the one-kv-head cache's sequence over "model"."""
    tree = cases["batch"][0]["tree"]
    data, model = shape
    for rank, r in enumerate(runs[shape]):
        got = r["batch"][0]
        di, mi = divmod(rank, model)
        np.testing.assert_array_equal(got["tokens"],
                                      np.split(tree["tokens"], data)[di])
        np.testing.assert_array_equal(got["odd"], tree["odd"])
        np.testing.assert_array_equal(got["cache"], np.split(
            np.split(tree["cache"], data, axis=1)[di], model, axis=2)[mi])


@pytest.mark.parametrize("window", [0, 3])
def test_decode_ref_start_and_lse(window):
    """The plain decode's per-slot ``start`` and ``lse``: ``start = len -
    window`` equals JAX's windowed ref, the lse is the log-sum-exp of the
    scaled scores attended, and an empty window gives 0 and -inf."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(26)
    B, S, H, hkv, dh = 5, 12, 4, 2, 8
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, dh)).astype(np.float32)
    lens = np.array([S, 5, 1, 0, 9], np.int32)
    start = np.maximum(lens - window, 0) if window else np.zeros(B, np.int32)
    out, lse = ref.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), start=torch.from_numpy(start), lse=True)
    want = np.asarray(jattn.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        window=window))
    live = lens > 0
    np.testing.assert_allclose(out.numpy()[live], want[live], atol=1e-6)
    assert not out.numpy()[~live].any()
    G = H // hkv
    for b in range(B):
        for h in range(H):
            rows = np.arange(start[b], lens[b])
            if not rows.size:
                assert lse[b, h] == -np.inf
                continue
            s = k[b, rows, h // G] @ q[b, 0, h] / np.sqrt(dh)
            want_lse = s.max() + np.log(np.exp(s - s.max()).sum())
            assert abs(float(lse[b, h]) - want_lse) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_moe_on_mesh_matches_moe_global(runs, cases, shape):
    """Expert-parallel and f_parallel: y within 1e-5 of ``_moe_global`` (no
    choice overflows at the reduced capacity factor 4.0, so every kept set
    is the global one), aux within 1e-6 of the batch shards' mean."""
    per_rank = [r["moe"] for r in runs[shape]]
    for i, (jcfg, layer, x) in enumerate(cases["moe"][1]):
        want_y, _ = jmoe._moe_global(layer, jnp.asarray(x), jcfg)
        got = np.zeros_like(x)
        for r in per_rank:
            got[r[i]["b0"]:r[i]["b0"] + r[i]["B_loc"]] = r[i]["y"]
        bsz = per_rank[0][i]["B_loc"]
        want_aux = np.mean([float(jmoe._moe_global(
            layer, jnp.asarray(x[d:d + bsz]), jcfg)[1])
            for d in range(0, x.shape[0], bsz)])
        np.testing.assert_allclose(got, np.asarray(want_y), atol=1e-5, rtol=0)
        for r in per_rank:
            assert abs(r[i]["aux"] - want_aux) <= 1e-6, (i, r[i]["aux"], want_aux)


def _assemble(blocks, full_shape, b_dim, s_dim, h_dim):
    out = np.full(full_shape, np.nan, np.float32)
    for c in blocks:
        idx = [slice(None)] * len(full_shape)
        idx[b_dim] = slice(c["b0"], c["b0"] + c["B_loc"])
        idx[s_dim] = slice(c["s0"], c["s0"] + c["S_loc"])
        idx[h_dim] = slice(c["h0"], c["h0"] + c["H_loc"])
        region = out[tuple(idx)]
        seen = ~np.isnan(region)
        # replicated blocks must agree bit for bit
        np.testing.assert_array_equal(region[seen], c["block"][seen])
        out[tuple(idx)] = c["block"]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_cache_writes_bit_equal_jax(runs, cases, shape):
    for i, case in enumerate(cases["cache"]):
        blocks = [r["cache"][i] for r in runs[shape]]
        if case["kind"] == "update":
            got = _assemble(blocks, case["cache"].shape, 0, 1, 2)
            S = case["cache"].shape[1]
            want = jattn.cache_update(jnp.asarray(case["cache"]),
                                      jnp.asarray(case["new"]),
                                      jnp.asarray(case["index"]))
            if any(c["S_loc"] < S for c in blocks):
                # an index past a sequence-sharded cache: JAX's plain update
                # clamps it onto the last row, its shard_map drops it (no
                # shard owns it)
                want = np.where(np.asarray(case["index"]).reshape(-1, 1, 1, 1)
                                >= case["cache"].shape[1], case["cache"], want)
        else:
            got = _assemble(blocks, case["dst"].shape, 1, 2, 3)
            want = jops.splice_blocks(jnp.asarray(case["dst"]),
                                      jnp.asarray(case["src"]),
                                      jnp.asarray(case["slot_ids"]))
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(i))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_decode_lse_merge_matches_ref(runs, cases, shape):
    for i, case in enumerate(cases["decode"]):
        got = np.full(case["q"].shape, np.nan, np.float32)
        for r in runs[shape]:
            c = r["decode"][i]
            got[c["b0"]:c["b0"] + c["B_loc"], :, c["h0"]:c["h0"] + c["H_loc"]] \
                = c["out"]
        want = np.asarray(jattn.decode_attention_ref(
            jnp.asarray(case["q"]), jnp.asarray(case["k"]),
            jnp.asarray(case["v"]), jnp.asarray(case["cache_len"]),
            window=case["window"]))
        live = case["cache_len"] > 0
        np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=1e-5)
        # an empty window is 0 (the kernel's contract), where the ref's
        # softmax over no row is NaN
        np.testing.assert_array_equal(got[~live], 0.0)


def test_head_parallel_logits_match_jax_forward(runs, cases):
    """(1, 2): heads, MLP width, vocab and experts split over "model";
    prefill and 4 decode steps within 1e-4 of JAX's off-mesh forward, and
    both ranks hold the same logits."""
    for i, case in enumerate(cases["logits"]):
        jcfg = jreduced(jget_config(case["arch"]))
        jp = jax.tree.map(jnp.asarray, case["params"])
        out = jM.forward(jp, jcfg, {"tokens": jnp.asarray(case["prompts"])},
                         mode="prefill")
        want = [np.asarray(out.logits[:, -1])]
        cache = jM.init_cache(jcfg, 2, case["max_len"], dtype=jnp.float32)
        from repro.serving.engine import seed_cache
        cache = seed_cache(jcfg, cache, out.cache, 8)
        for s, tok in enumerate(case["tokens"]):
            o = jM.forward(jp, jcfg, {"token": jnp.asarray(tok)[:, None],
                                      "cache": cache,
                                      "cache_index": jnp.int32(8 + s)},
                           mode="decode")
            cache = o.cache
            want.append(np.asarray(o.logits[:, 0]))
        rank_logits = [r["logits"][i]["logits"] for r in runs[(1, 2)]]
        for got in rank_logits:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        for g0, g1 in zip(*rank_logits):
            np.testing.assert_array_equal(g0, g1)
