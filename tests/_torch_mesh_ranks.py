"""Rank functions of the port's multi-rank tests (``test_torch_mesh*.py``).

Each runs in a spawned process on a gloo mesh (``repro_torch.distributed.
spawn.run_ranks``); it takes numpy inputs made by the test, runs the port's
sharded code on its block and returns numpy results with the coordinates
of that block, which the test assembles and holds against the JAX
package's off-mesh functions.  This module imports no JAX: the ranks never
load it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_from_numpy
from repro_torch.launch.mesh import Mesh, shard_params
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.models.attention import cache_update, decode_attend
from repro_torch.models.moe import moe_apply, moe_sharded
from repro_torch.kernels import ops


def make_cfg(arch: str, **replace):
    return dataclasses.replace(reduced(get_config(arch)), **replace)


def make_mesh(shape):
    """(data, model) for a 2-d ``shape``, (pod, data, model) for a 3-d one."""
    world = int(np.prod(shape))
    axes = ("pod", "data", "model")[-len(shape):]
    return Mesh(np.arange(world).reshape(shape), axes)


def _heads(mesh, hkv: int, h: int):
    """(h0, H_loc, k0, Hkv_loc): this rank's query and kv heads."""
    m = mesh.shape["model"]
    if hkv % m == 0 and hkv >= m:
        mi = mesh.axis_index("model")
        return mi * (h // m), h // m, mi * (hkv // m), hkv // m
    return 0, h, 0, hkv


def _block(a, shard, k0, hkv_loc, *, batch_dim=0, seq_dim=1, head_dim=2):
    """This rank's block of a global [.., B, S, Hkv, dh] array."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    t = t.narrow(batch_dim, shard.b0, shard.B_loc)
    if shard.seq is not None:
        t = t.narrow(seq_dim, shard.s0, shard.S_loc)
    return t.narrow(head_dim, k0, hkv_loc).contiguous()


def _where(shard, k0, hkv_loc):
    return dict(b0=shard.b0, B_loc=shard.B_loc,
                s0=shard.s0 if shard.seq is not None else 0,
                S_loc=shard.S_loc, h0=k0, H_loc=hkv_loc)


def ops_rank(rank, world, shape, cases):
    """Runs every case of ``cases`` (a list of dicts with a ``kind``) on
    this rank of a (data, model) mesh of ``shape``."""
    torch.manual_seed(0)
    mesh = make_mesh(shape)
    out = []
    for case in cases:
        kind = case["kind"]
        if kind == "moe":
            out.append(_moe_case(mesh, case))
        elif kind == "update":
            out.append(_update_case(mesh, case))
        elif kind == "splice":
            out.append(_splice_case(mesh, case))
        elif kind == "decode":
            out.append(_decode_case(mesh, case))
        elif kind == "logits":
            out.append(_logits_case(mesh, case))
        elif kind == "batch":
            from repro_torch.launch.mesh import shard_batch
            tree = {k: torch.from_numpy(v) for k, v in case["tree"].items()}
            out.append({k: v.numpy() for k, v in shard_batch(tree, mesh).items()})
        else:
            raise ValueError(kind)
    return out


def _moe_case(mesh, case):
    cfg = make_cfg(case["arch"])
    p = tree_from_numpy(case["params"], "cpu")
    x = torch.from_numpy(case["x"])
    shard = sharding.rank_shard(mesh, x.shape[0])
    xl = x[shard.b0:shard.b0 + shard.B_loc]
    if case["f_parallel"]:
        m, mi = mesh.shape["model"], mesh.axis_index("model")
        f = cfg.d_ff // m
        p = dict(p, w_gate=p["w_gate"][..., mi * f:(mi + 1) * f],
                 w_up=p["w_up"][..., mi * f:(mi + 1) * f],
                 w_down=p["w_down"][:, mi * f:(mi + 1) * f])
        if "shared" in p:
            p["shared"] = shard_params({"moe": {"shared": p["shared"]}},
                                       mesh)["moe"]["shared"]
        y, aux = moe_sharded(p, xl, cfg, shard, f_parallel=True)
    else:
        p = shard_params({"moe": p}, mesh)["moe"]
        y, aux = moe_apply(p, xl, cfg, shard=shard)
    return dict(y=y.numpy(), aux=float(aux), b0=shard.b0, B_loc=shard.B_loc)


def _update_case(mesh, case):
    cache = case["cache"]                       # [B, S, Hkv, dh]
    B, S, hkv, _ = cache.shape
    shard = sharding.rank_shard(mesh, B, Hkv=hkv, S=S)
    _, _, k0, hl = _heads(mesh, hkv, hkv)
    local = _block(cache, shard, k0, hl)
    new = torch.from_numpy(case["new"]).narrow(0, shard.b0, shard.B_loc) \
        .narrow(2, k0, hl).contiguous()
    index = torch.as_tensor(case["index"])
    if index.dim():
        index = index[shard.b0:shard.b0 + shard.B_loc]
    cache_update(local, new, index, shard)
    return dict(block=local.numpy(), **_where(shard, k0, hl))


def _splice_case(mesh, case):
    dst = case["dst"]                           # [L, B, S, Hkv, dh]
    _, B, S, hkv, _ = dst.shape
    shard = sharding.rank_shard(mesh, B, Hkv=hkv, S=S)
    _, _, k0, hl = _heads(mesh, hkv, hkv)
    local = _block(dst, shard, k0, hl, batch_dim=1, seq_dim=2, head_dim=3)
    src = torch.from_numpy(case["src"]).narrow(3, k0, hl).contiguous()
    ops.splice_blocks(local, src, torch.as_tensor(case["slot_ids"]), shard)
    return dict(block=local.numpy(), **_where(shard, k0, hl))


def _decode_case(mesh, case):
    k, v, q = case["k"], case["v"], case["q"]
    B, S, hkv, _ = k.shape
    H = q.shape[2]
    shard = sharding.rank_shard(mesh, B, Hkv=hkv, S=S)
    h0, H_loc, k0, hl = _heads(mesh, hkv, H)
    kl = _block(k, shard, k0, hl)
    vl = _block(v, shard, k0, hl)
    ql = torch.from_numpy(q).narrow(0, shard.b0, shard.B_loc) \
        .narrow(2, h0, H_loc).contiguous()
    cl = torch.from_numpy(case["cache_len"])[shard.b0:shard.b0 + shard.B_loc]
    out = decode_attend(ql, kl, vl, cl, window=case["window"],
                        use_kernels=False, shard=shard)
    return dict(out=out.numpy(), b0=shard.b0, B_loc=shard.B_loc, h0=h0,
                H_loc=H_loc)


def _logits_case(mesh, case):
    from repro_torch.serving.engine import seed_cache
    cfg = make_cfg(case["arch"])
    params = shard_params(params_from_numpy(case["params"], cfg, "cpu"), mesh)
    prompts = torch.from_numpy(case["prompts"])
    B, P = prompts.shape
    S = case["max_len"]
    logits = []
    with torch.no_grad(), sharding.activation_sharding(mesh):
        out = M.forward(params, cfg, {"tokens": prompts}, mode="prefill")
        logits.append(out.logits[:, -1].numpy())
        cache = M.init_cache(cfg, B, S, device="cpu")
        shard = M.cache_shard(cfg, B, S)
        seed_cache(cfg, cache, out.cache, P, shard)
        for i, tok in enumerate(case["tokens"]):
            out = M.forward(params, cfg,
                            {"token": torch.from_numpy(tok)[:, None],
                             "cache": cache,
                             "cache_index": torch.tensor(P + i)},
                            mode="decode", shard=shard)
            logits.append(out.logits[:, 0].numpy())
    return dict(logits=logits)


def engine_rank(rank, world, shape, arch, replace, params_np, prompts,
                max_news, slots, max_len):
    """test_scaleout's scenario on this rank: the disaggregated arm (a
    PrefillWorker, macro_steps=4), its profile, the local arm and the
    per-step arm, on a (data, model) mesh of ``shape``."""
    from repro_torch.serving.engine import ContinuousServingEngine, ServeRequest
    from repro_torch.serving.prefill import PrefillWorker
    from repro_torch.serving.profiling import profile_engine_programs
    cfg = make_cfg(arch, **replace)
    mesh = make_mesh(shape)
    params = shard_params(params_from_numpy(params_np, cfg, "cpu"), mesh)
    reqs = [ServeRequest(uid=i, prompt=prompts[i], max_new=m)
            for i, m in enumerate(max_news)]

    def arm(outs, st):
        return {"streams": [o.tokens.tolist() for o in outs],
                "stalls": st.admission_stalls,
                "offloaded": st.prefill_offloaded,
                "decode_s": st.decode_s, "t_dispatch_s": st.t_dispatch_s,
                "t_await_s": st.t_await_s, "t_splice_s": st.t_splice_s,
                "t_slot_write_s": st.t_slot_write_s}

    res = {"mesh": dict(mesh.shape), "rank": rank}
    with sharding.activation_sharding(mesh):
        w = PrefillWorker(cfg, params, device="cpu")
        eng = ContinuousServingEngine(cfg, params, slots=slots,
                                      max_len=max_len, macro_steps=4,
                                      prefill_worker=w, device="cpu")
        res["disagg"] = arm(*eng.run(reqs))
        res["profile"] = profile_engine_programs(eng, prompt_len=len(prompts[0]),
                                                 n_blocks=2)
        leng = ContinuousServingEngine(cfg, params, slots=slots,
                                       max_len=max_len, macro_steps=4,
                                       share_from=eng, device="cpu")
        res["local"] = arm(*leng.run(reqs))
        peng = ContinuousServingEngine(cfg, params, slots=slots,
                                       max_len=max_len, macro_steps=0,
                                       device="cpu")
        res["per_step"] = arm(*peng.run(reqs))
        res["cache_block"] = list(M.init_cache(cfg, slots, max_len,
                                               device="cpu")["self"]["k"].shape)
    return res


def profile_rank(rank, world, shape, arch, replace, slots, max_len, K,
                 prompt_len):
    """``profile_engine_programs`` of a continuous engine (the port's own
    seed-0 weights) on this rank of a (data, model) mesh."""
    from repro_torch.serving.engine import ContinuousServingEngine
    from repro_torch.serving.profiling import profile_engine_programs
    cfg = make_cfg(arch, **replace)
    mesh = make_mesh(shape)
    params = shard_params(M.init_params(cfg, 0, device="cpu"), mesh)
    with sharding.activation_sharding(mesh):
        eng = ContinuousServingEngine(cfg, params, slots=slots,
                                      max_len=max_len, macro_steps=K,
                                      device="cpu")
        return profile_engine_programs(eng, prompt_len=prompt_len)


# ---------------------------------------------------------------------------
# The SSM, hybrid, vlm and audio families on a mesh
# ---------------------------------------------------------------------------
def family_rank(rank, world, shape, cases):
    """Runs every case of ``cases`` (kinds "mamba", "family_logits",
    "family_cache") on this rank of a (data, model) mesh of ``shape``."""
    torch.manual_seed(0)
    mesh = make_mesh(shape)
    kinds = {"mamba": _mamba_case, "family_logits": _family_logits_case,
             "family_cache": _family_cache_case}
    return [kinds[case["kind"]](mesh, case) for case in cases]


def _mamba_case(mesh, case):
    """One Mamba mixer (JAX's layer params) on this rank's channels:
    prefill, then one decode step from the prefill's state."""
    from repro_torch.models.ssm import mamba_apply
    cfg = make_cfg(case["arch"])
    p = shard_params({"mamba": tree_from_numpy(case["params"], "cpu")},
                     mesh)["mamba"]
    x, x1 = torch.from_numpy(case["x"]), torch.from_numpy(case["x1"])
    shard = sharding.rank_shard(mesh, x.shape[0])
    with torch.no_grad():
        y, (conv, h) = mamba_apply(p, x, cfg, mode="full", shard=shard)
        y1, (conv1, h1) = mamba_apply(p, x1, cfg, state=(conv.clone(),
                                                         h.clone()),
                                      mode="decode", shard=shard)
    return dict(y=y.numpy(), conv=conv.numpy(), h=h.numpy(), y1=y1.numpy(),
                conv1=conv1.numpy(), h1=h1.numpy(),
                mi=mesh.axis_index("model"), di=p["conv_w"].shape[-1])


def _family_logits_case(mesh, case):
    """Prefill (with the case's frontend) and teacher-forced decode steps on
    this rank's block: every step's whole-batch logits and the all_reduces
    each decode step ran."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.serving.engine import seed_cache
    cfg = make_cfg(case["arch"])
    params = shard_params(params_from_numpy(case["params"], cfg, "cpu"), mesh)
    batch = {"tokens": torch.from_numpy(case["prompts"])}
    if case["frontend"] is not None:
        batch["frontend"] = torch.from_numpy(case["frontend"])
    B, P = case["prompts"].shape
    rows, S = P + M.frontend_offset(cfg), case["max_len"]
    logits, calls = [], []
    with torch.no_grad(), sharding.activation_sharding(mesh):
        out = M.forward(params, cfg, batch, mode="prefill")
        logits.append(out.logits[:, -1].numpy())
        cache = M.init_cache(cfg, B, S, device="cpu")
        shard = M.cache_shard(cfg, B, S)
        seed_cache(cfg, cache, out.cache, rows, shard)
        for i, tok in enumerate(case["tokens"]):
            with coll.counting(mesh) as cc:
                out = M.forward(params, cfg,
                                {"token": torch.from_numpy(tok)[:, None],
                                 "cache": cache,
                                 "cache_index": torch.tensor(rows + i)},
                                mode="decode", shard=shard)
            calls.append(cc.calls["all-reduce"])
            logits.append(out.logits[:, 0].numpy())
    return dict(logits=logits, all_reduce_calls=calls,
                b_sharded=shard.b_sharded, seq=shard.seq is not None)


def cache_block(cfg, tree, mesh, shard, *, rows=True, seq=True):
    """This rank's block of a whole (one-rank) cache tree, leaf by leaf by
    role: batch rows [b0, b0 + B_loc) of every leaf (``rows``); a Mamba
    state's channels (Mamba-2: heads) when the mixer splits; a K/V leaf's
    kv heads when they divide "model" and, under ``seq``, its sequence
    shard; a cross K/V leaf all of its F rows."""
    from repro_torch.launch.mesh import mamba_splits
    m = mesh.shape["model"]
    mi = mesh.axis_index("model")

    def cut(t, dim, n):
        step = t.shape[dim] // n
        return t.narrow(dim, mi * step, step)

    def batch(t):
        return t.narrow(1, shard.b0, shard.B_loc) if rows else t

    def state(t, dim):
        di = cfg.d_inner
        heads = di // cfg.ssm_head_dim if cfg.mamba_version == 2 else 0
        return cut(batch(t), dim, m) if mamba_splits(di, heads, m) \
            else batch(t)

    def kv(t, cross=False):
        t = batch(t)
        hkv = cfg.num_kv_heads
        if hkv % m == 0 and hkv >= m:
            t = cut(t, 3, m)
        if seq and not cross and shard.seq is not None:
            t = t.narrow(2, shard.s0, shard.S_loc)
        return t

    def states(pair):
        conv, ssm = pair
        return (state(conv, 3), state(ssm, 2))

    def kvs(d, cross=False):
        return {k: kv(v, cross) for k, v in d.items()}

    if isinstance(tree, tuple):
        return states(tree)
    if "backbone" in tree:
        return {"backbone": states(tree["backbone"]),
                "shared": {"self": kvs(tree["shared"]["self"])}}
    out = {"self": kvs(tree["self"])}
    if "cross" in tree:
        out["cross"] = kvs(tree["cross"], cross=True)
    return out


def _family_cache_case(mesh, case):
    """seed_cache, write_slot_cache and splice_slot_caches on this rank's
    block against the same ops on the whole one-rank cache, by leaf: the
    caches and prefill blocks are numpy draws from the case's seed (the
    same on every rank), each rank cuts its blocks with
    :func:`cache_block`.  Returns, per op, each leaf's largest difference
    from the one-rank result's block, and the shapes ``init_cache``
    allocates on the mesh beside those ``cache_block`` cuts."""
    from repro_torch.core.offload import tree_leaves, tree_map
    from repro_torch.serving.engine import (seed_cache, splice_slot_caches,
                                            write_slot_cache)
    cfg = make_cfg(case["arch"])
    B, S, P, ids = case["slots"], case["max_len"], case["prefill"], case["ids"]
    rng = np.random.default_rng(case["seed"])

    def draw(tree):
        return tree_map(lambda t: torch.from_numpy(rng.standard_normal(
            tuple(t.shape)).astype(np.float32)), tree)

    def prefill_cache(n):
        """An n-row prefill cache of P prompt rows (the cross K/V's F)."""
        return draw(M.init_cache(cfg, n, P, device="cpu"))

    whole = draw(M.init_cache(cfg, B, S, device="cpu"))
    seed_src, slot_src = prefill_cache(B), prefill_cache(1)
    blocks = [prefill_cache(1) for _ in ids]
    slot_ids = torch.as_tensor(ids, dtype=torch.int32)
    with sharding.activation_sharding(mesh):
        shard = M.cache_shard(cfg, B, S)
        local_shapes = [tuple(t.shape) for t in
                        tree_leaves(M.init_cache(cfg, B, S, device="cpu"))]
    clone = lambda tree: tree_map(lambda t: t.clone(), tree)  # noqa: E731
    out = {"shapes": local_shapes,
           "cut_shapes": [tuple(t.shape) for t in
                          tree_leaves(cache_block(cfg, whole, mesh, shard))],
           "b_sharded": shard.b_sharded, "seq": shard.seq is not None}
    ops_ = {
        "seed": (lambda c, sh, blk: seed_cache(cfg, c, blk(seed_src, True),
                                               P, sh)),
        "slot_write": (lambda c, sh, blk: write_slot_cache(
            cfg, c, blk(slot_src, False), case["slot"], sh)),
        "splice": (lambda c, sh, blk: splice_slot_caches(
            cfg, c, [blk(b, False) for b in blocks], slot_ids, sh)),
    }
    for name, op in ops_.items():
        want = op(clone(whole), None, lambda t, _: t)
        got = op(clone(cache_block(cfg, whole, mesh, shard)), shard,
                 lambda t, rows: cache_block(cfg, t, mesh, shard, rows=rows,
                                             seq=False))
        want = cache_block(cfg, want, mesh, shard)
        out[name] = [float((g - w).abs().max())
                     for g, w in zip(tree_leaves(got), tree_leaves(want))]
    return out


def family_engine_rank(rank, world, shape, scenarios):
    """Each scenario's continuous engine (JAX's params of its ``arch``) on
    this rank of a (data, model) mesh of ``shape``: the per-step arm, the
    local overlapped arm (K=4), the disaggregated arm (a mesh-wide
    PrefillWorker) and, with ``cached``, that arm with a PrefixCache
    (block 4: the vlm's prologue root and token blocks); the profile of
    the engine's programs; the cache block it allocates."""
    from repro_torch.core.offload import tree_leaves
    from repro_torch.serving.engine import ContinuousServingEngine, ServeRequest
    from repro_torch.serving.prefill import PrefillWorker
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.profiling import profile_engine_programs
    mesh = make_mesh(shape)
    out = []
    for sc in scenarios:
        cfg = make_cfg(sc["arch"])
        params = shard_params(params_from_numpy(sc["params"], cfg, "cpu"), mesh)
        reqs = [ServeRequest(uid=i, prompt=p, max_new=m, frontend=f)
                for i, (p, m, f) in enumerate(zip(sc["prompts"], sc["max_news"],
                                                  sc["frontend"]))]
        kw = dict(slots=sc["slots"], max_len=sc["max_len"], device="cpu")
        res = {"rank": rank}
        with sharding.activation_sharding(mesh):
            arms = {"per_step": dict(macro_steps=0),
                    "local": dict(macro_steps=4),
                    "disagg": dict(macro_steps=4, prefill_worker=PrefillWorker(
                        cfg, params, device="cpu"))}
            if sc["cached"]:
                arms["cached"] = dict(
                    macro_steps=4,
                    prefix_cache=PrefixCache(cfg, block_size=4, device="cpu"),
                    prefill_worker=PrefillWorker(cfg, params, device="cpu"))
            for name, extra in arms.items():
                eng = ContinuousServingEngine(cfg, params, **kw, **extra)
                outs, st = eng.run(reqs)
                res[name] = {"streams": [o.tokens.tolist() for o in outs],
                             "offloaded": st.prefill_offloaded,
                             "prefix_hits": st.prefix_hits,
                             "kv_hop_bytes_wire": st.kv_hop_bytes_wire,
                             "kv_hop_bytes_raw": st.kv_hop_bytes_raw}
            res["profile"] = profile_engine_programs(
                eng, prompt_len=len(sc["prompts"][0]), n_blocks=2)
            res["shard"] = {"b_sharded": eng._shard.b_sharded,
                            "seq": eng._shard.seq is not None}
            res["cache_block"] = [list(t.shape) for t in tree_leaves(
                M.init_cache(cfg, sc["slots"], sc["max_len"], device="cpu"))]
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# Training across ranks
# ---------------------------------------------------------------------------
def collectives_rank(rank, world, shape, seed):
    """Each differentiable collective of ``distributed/collectives.py`` on
    this rank of a (data, model) mesh of ``shape``, on inputs drawn from
    ``seed`` (the same draws on every rank; each rank takes its own slice
    where the op wants rank-local values).  Returns every output, input
    gradient and counter reading; ``tests/test_torch_mesh_collectives.py``
    holds them against one-process sums."""
    from repro_torch.distributed import collectives as coll
    mesh = make_mesh(shape)
    rng = np.random.default_rng(seed)
    m, d = mesh.shape["model"], mesh.shape["data"]
    mi, di = mesh.axis_index("model"), mesh.axis_index("data")
    x = rng.standard_normal((m, 3, 5)).astype(np.float32)     # per model rank
    c = rng.standard_normal((m, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    full = rng.standard_normal((d, 6, 4)).astype(np.float32)  # per data rank
    wd = rng.standard_normal((d, d * 6, 4)).astype(np.float32)
    W = rng.standard_normal((m, 3, 5)).astype(np.float32)

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)

    out = {}

    def run(name, fn, *inputs):
        with coll.counting(mesh) as cc:
            y = fn(*inputs)
            fwd = (dict(cc.calls), dict(cc.bytes))
            y.backward()
        out[name] = {"grads": [t.grad.numpy() for t in inputs],
                     "fwd": fwd, "all": (dict(cc.calls), dict(cc.bytes))}

    wt = torch.from_numpy(w)
    # g: rank-partial x summed; the replicated loss passes its gradient on
    run("reduce_partial", lambda t: (coll.reduce_partial(t, mesh, ("model",))
                                     * wt).sum(), leaf(x[mi]))
    out["reduce_partial"]["y"] = coll.reduce_partial(
        torch.from_numpy(x[mi].copy()), mesh, ("model",)).numpy()
    # f then g: a replicated value through rank-partial work
    ct = torch.from_numpy(c[mi])
    run("enter_partial", lambda t: (coll.reduce_partial(
        coll.enter_partial(t, mesh, ("model",)) * ct, mesh, ("model",))
        * wt).sum(), leaf(x[0]))
    # partial sums feeding rank-partial work again
    run("reduce_to_partial", lambda t: (coll.reduce_partial(
        coll.reduce_to_partial(t, mesh, ("model",)) * ct, mesh, ("model",))
        * wt).sum(), leaf(x[mi]))
    # the vocab gather: each rank's block, a replicated loss
    Wt = torch.from_numpy(W)
    run("gather_partial", lambda t: (coll.gather_partial(t, mesh, ("model",))
                                     * Wt).sum(), leaf(x[mi]))
    # FSDP over "data": slice di of a [d*6, 4] leaf; each rank's own loss
    shard = full.reshape(d * 6, 4)[di * 6:(di + 1) * 6]
    wdt = torch.from_numpy(wd[di])
    run("fsdp_gather", lambda t: (coll.fsdp_gather(t, mesh, ("data",), 0)
                                  * wdt).sum(), leaf(shard))
    out["fsdp_gather"]["y"] = coll.fsdp_gather(
        torch.from_numpy(shard), mesh, ("data",), 0).detach().numpy()
    # the mean of each rank's value over "data"
    with coll.counting(mesh) as cc:
        mean = coll.mean(torch.tensor([float(di), 2.0 * di + 1.0]), mesh,
                         ("data",))
    out["mean"] = {"y": mean.numpy(), "all": (dict(cc.calls), dict(cc.bytes))}
    # off the autograd graph (serving): the in-place all_reduce, the
    # identity, gather_sum, each counted as before
    serving = {}
    with torch.no_grad(), coll.counting(mesh) as cc:
        t = torch.from_numpy(x[mi].copy())
        r = coll.reduce_partial(t, mesh, ("model",))
        serving["reduce_in_place"] = r is t
        serving["reduced"] = r.numpy().copy()
        u = torch.from_numpy(x[0].copy())
        serving["enter_is_identity"] = coll.enter_partial(u, mesh, ("model",)) is u
        t2 = torch.from_numpy(x[mi].copy())
        serving["to_partial_in_place"] = \
            coll.reduce_to_partial(t2, mesh, ("model",)) is t2
        serving["gathered"] = coll.gather_partial(
            torch.from_numpy(x[mi]), mesh, ("model",)).numpy()
    serving["counts"] = (dict(cc.calls), dict(cc.bytes))
    out["serving"] = serving
    out["coords"] = (di, mi)
    return out


def _named(tree):
    """{JAX key path: numpy array} of a tree of tensors."""
    from repro_torch.training.checkpoint import named_leaves
    return {k: v.detach().numpy().copy() for k, v in named_leaves(tree)}


def train_rank(rank, world, shape, cases):
    """Runs every training case on this rank of a (data, model) mesh of
    ``shape``: JAX's params (numpy) cut by ``shard_params(fsdp=True)``,
    then ``make_train_step`` over the case's batches.  Returns each step's
    metrics and collective counts, the whole params after the first step,
    the first batch's whole gradients (``step_grads``, gathered; with
    ``remat`` too when the case asks) and their ``global_norm`` on the
    mesh; ``save`` writes a checkpoint after the last step (and returns the
    whole state written), ``restore`` reads one into this mesh's shards
    (and returns them gathered)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import (gather_params, shard_params,
                                         train_layout)
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    torch.manual_seed(0)
    mesh = make_mesh(shape)
    out = []
    for case in cases:
        cfg = make_cfg(case["arch"])
        full = params_from_numpy(case["params"], cfg, "cpu")
        layout = train_layout(full, mesh)
        params = shard_params(full, mesh, fsdp=True)
        res = {"rank": rank}
        if case.get("restore"):
            state = opt.init_opt_state(params)
            p, s, meta = ckpt.restore_checkpoint(case["restore"], params,
                                                 state, layout=layout)
            res["restored"] = _named(gather_params(p, layout))
            res["restored_opt"] = {
                "step": int(s.step), **{f"m/{k}": v for k, v in
                                         _named(gather_params(s.m, layout)).items()},
                **{f"v/{k}": v for k, v in
                   _named(gather_params(s.v, layout)).items()}}
            res["meta"] = meta
            out.append(res)
            continue
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in case["batches"]]
        _, _, g = T.step_grads(params, cfg, batches[0], remat=False,
                               layout=layout)
        res["grads"] = _named(gather_params(g, layout))
        res["global_norm"] = float(opt.global_norm(g, layout))
        if case.get("remat_grads"):
            _, _, gr = T.step_grads(params, cfg, batches[0], remat=True,
                                    layout=layout)
            res["remat_grads"] = _named(gather_params(gr, layout))
        del g
        state = opt.init_opt_state(params)
        step = T.make_train_step(cfg, opt.OptimizerConfig(**case["opt"]),
                                 remat=case.get("remat", False),
                                 microbatches=case.get("microbatches", 1),
                                 layout=layout)
        res["metrics"], res["collectives"] = [], []
        for i, batch in enumerate(batches):
            with coll.counting(mesh) as cc:
                params, state, m = step(params, state, batch)
            res["metrics"].append({k: float(v) for k, v in m.items()})
            res["collectives"].append({"calls": dict(cc.calls),
                                       "bytes": dict(cc.bytes)})
            if i == 0:
                res["params_step1"] = _named(gather_params(params, layout))
        res["step"] = int(state.step)
        if case.get("save"):
            ckpt.save_checkpoint(case["save"], params, state,
                                 metadata={"arch": cfg.name}, layout=layout)
            res["saved"] = {"params": _named(gather_params(params, layout)),
                            "m": _named(gather_params(state.m, layout)),
                            "v": _named(gather_params(state.v, layout)),
                            "step": int(state.step)}
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# The attention, vocab and frontend cuts of JAX's param_spec fallback
# ---------------------------------------------------------------------------
def _leaf_bytes(tree):
    """{JAX key path: bytes} of a tree of tensors."""
    from repro_torch.training.checkpoint import named_leaves
    return {k: v.numel() * v.element_size() for k, v in named_leaves(tree)}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_np_tree(v) for v in tree)
    return tree.detach().numpy().copy()


def fallback_rank(rank, world, shape, cases):
    """Serving under the "q" / "d" attention cuts and a table or
    ``frontend_proj`` on D: each case's config (``arch`` + ``replace``)
    with JAX's params cut by ``shard_params`` on this rank of a mesh of
    ``shape``.  A greedy stream of ``new`` tokens from the case's prompts:
    returns the cuts, each leaf's bytes, the prefill's and each decode
    step's logits, each step's all_reduces, the stream, and this rank's
    cache block after the last step beside the same block of the case's
    reference cache (``cache``, whole)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import model_cuts
    from repro_torch.serving.engine import seed_cache
    mesh = make_mesh(shape)
    out = []
    for case in cases:
        cfg = make_cfg(case["arch"], **case["replace"])
        params = shard_params(params_from_numpy(case["params"], cfg, "cpu"),
                              mesh)
        batch = {"tokens": torch.from_numpy(case["prompts"])}
        if case["frontend"] is not None:
            batch["frontend"] = torch.from_numpy(case["frontend"])
        B, P = case["prompts"].shape
        rows, S = P + M.frontend_offset(cfg), case["max_len"]
        res = {"cuts": model_cuts(cfg, mesh.shape["model"])._asdict(),
               "param_bytes": _leaf_bytes(params), "logits": [], "calls": []}
        with torch.no_grad(), sharding.activation_sharding(mesh):
            pre = M.forward(params, cfg, batch, mode="prefill")
            res["logits"].append(pre.logits[:, -1].numpy())
            shard = M.cache_shard(cfg, B, S)
            cache = M.init_cache(cfg, B, S, device="cpu")
            seed_cache(cfg, cache, pre.cache, rows, shard)
            stream = [pre.logits[:, -1].argmax(-1).to(torch.int32)]
            for i in range(case["new"] - 1):
                with coll.counting(mesh) as cc:
                    o = M.forward(params, cfg,
                                  {"token": stream[-1][:, None],
                                   "cache": cache,
                                   "cache_index": torch.tensor(rows + i)},
                                  mode="decode", shard=shard)
                res["calls"].append(cc.calls["all-reduce"])
                res["logits"].append(o.logits[:, 0].numpy())
                stream.append(o.logits[:, 0].argmax(-1).to(torch.int32))
            want = tree_from_numpy(case["cache"], "cpu")
            res["cache"] = _np_tree(cache)
            res["cache_want"] = _np_tree(cache_block(cfg, want, mesh, shard))
        res["stream"] = torch.stack(stream, 1).numpy()
        res["seq"] = shard.seq is not None
        res["b_sharded"] = shard.b_sharded
        out.append(res)
    return out


def fallback_train_rank(rank, world, shape, cases):
    """Training under the fallback cuts: each case's config with JAX's
    params cut by ``shard_params(fsdp=)``; the first batch's loss and whole
    gradients (``step_grads``, gathered; with ``remat`` too when the case
    asks), then one ``make_train_step`` step's collectives by kind."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import gather_params, train_layout
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    torch.manual_seed(0)
    mesh = make_mesh(shape)
    out = []
    for case in cases:
        cfg = make_cfg(case["arch"], **case["replace"])
        full = params_from_numpy(case["params"], cfg, "cpu")
        layout = train_layout(full, mesh, fsdp=case["fsdp"])
        params = shard_params(full, mesh, fsdp=case["fsdp"])
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        res = {"rank": rank, "param_bytes": _leaf_bytes(params)}
        loss, parts, g = T.step_grads(params, cfg, batch, remat=False,
                                      layout=layout)
        res["loss"], res["ce"] = float(loss), float(parts["ce"])
        res["grads"] = _named(gather_params(g, layout))
        del g
        if case.get("remat"):
            _, _, g = T.step_grads(params, cfg, batch, remat=True,
                                   layout=layout)
            res["remat_grads"] = _named(gather_params(g, layout))
            del g
        step = T.make_train_step(cfg, opt.OptimizerConfig(
            lr=1e-3, warmup_steps=1, total_steps=2), remat=False,
            layout=layout)
        with coll.counting(mesh) as cc:
            step(params, opt.init_opt_state(params), batch)
        res["collectives"] = {"calls": dict(cc.calls), "bytes": dict(cc.bytes)}
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# The vocab-parallel cross-entropy
# ---------------------------------------------------------------------------
class _LastDims(TorchDispatchMode):
    """The last dim of every tensor an operator returns while active."""

    def __init__(self):
        super().__init__()
        self.dims = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dim():
                self.dims.add(int(t.shape[-1]))
        return out


def _block_ce_case(mesh, case):
    """``layers.vocab_block_logits`` + ``cross_entropy(vocab=)`` on this
    rank's cut of a [V, D] table (its vocab rows or its D columns): the
    loss, the block's width and the gradients of x and of the rank's part
    of the table."""
    from repro_torch.models.layers import vocab_block_logits
    m, mi = mesh.shape["model"], mesh.axis_index("model")
    table = torch.from_numpy(case["table"])
    V, D = table.shape
    if case["cut"] == "d":
        part = table[:, mi * (D // m):(mi + 1) * (D // m)]
    else:
        part = table[mi * (V // m):(mi + 1) * (V // m)]
    part = part.clone().requires_grad_(True)
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    mask = None if case["mask"] is None else torch.from_numpy(case["mask"])
    logits, vocab = vocab_block_logits(x, part, mesh, cut=case["cut"])
    loss = M.cross_entropy(logits, torch.from_numpy(case["labels"]), mask,
                           vocab=vocab)
    gx, gt = torch.autograd.grad(loss, (x, part))
    return dict(loss=float(loss), width=int(logits.shape[-1]),
                start=vocab.start, gx=gx.numpy(), gt=gt.numpy(), mi=mi)


def _model_ce_case(mesh, case):
    """A train step's loss on this rank: the train-mode logits' shape, the
    last dims of every tensor ``step_grads`` makes, its loss and whole
    gradients, then one ``make_train_step`` step's collectives."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import gather_params, train_layout
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    cfg = make_cfg(case["arch"], **case["replace"])
    full = params_from_numpy(case["params"], cfg, "cpu")
    layout = train_layout(full, mesh, fsdp=case["fsdp"])
    params = shard_params(full, mesh, fsdp=case["fsdp"])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    shard = sharding.rank_shard(mesh, batch["tokens"].shape[0])
    rows = {k: v[shard.b0:shard.b0 + shard.B_loc] for k, v in batch.items()}
    with torch.no_grad(), sharding.activation_sharding(mesh):
        out = M.forward(params, cfg, rows, mode="train", shard=shard,
                        fsdp=layout.fsdp_dims())
    res = {"logits_shape": tuple(out.logits.shape)}
    with _LastDims() as seen:
        loss, parts, g = T.step_grads(params, cfg, batch, remat=False,
                                      layout=layout)
    res["last_dims"] = sorted(seen.dims)
    res["loss"], res["ce"] = float(loss), float(parts["ce"])
    res["grads"] = _named(gather_params(g, layout))
    del g
    step = T.make_train_step(cfg, opt.OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=2), remat=False, layout=layout)
    with coll.counting(mesh) as cc:
        step(params, opt.init_opt_state(params), batch)
    res["collectives"] = {"calls": dict(cc.calls), "bytes": dict(cc.bytes)}
    return res


def vocab_ce_rank(rank, world, shape, cases):
    """Each case on this rank of a (data, model) mesh of ``shape``: a
    ``block`` case (:func:`_block_ce_case`) or a ``model`` one
    (:func:`_model_ce_case`)."""
    torch.manual_seed(0)
    mesh = make_mesh(shape)
    return [dict(rank=rank, **(_block_ce_case(mesh, c) if c["kind"] == "block"
                               else _model_ce_case(mesh, c)))
            for c in cases]
