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
    world = int(np.prod(shape))
    return Mesh(np.arange(world).reshape(shape), ("data", "model"))


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
