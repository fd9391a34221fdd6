"""Serving launcher with HeteroEdge collaborative offloading.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 16 --prompt-len 128 --max-new 32 [--reduced] [--kv-int8] \
        [--split auto|none|<r>] [--macro-steps 8] [--device cuda|cpu] \
        [--topology pair|star] [--nodes N] \
        [--continuous] [--slots 4] [--wave-steps 1] \
        [--no-overlap-admission] [--prefill-group G] \
        [--prefix-cache-blocks N] [--prefix-block-size T] \
        [--prefill-pool W] [--kv-keep-rate R] \
        [--link-trace 4,12,28,12,4 [--mobility-beta 10]] \
        [--power-budget-wh WH [--power-threshold-w W]] \
        [--frontend [--tenants SPEC] [--queue-depth N] [--shed-depth N]] \
        [--telemetry-json out.json]

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m repro_torch.launch.serve --mesh DATAxMODEL \
        [--dist-backend nccl|gloo] [--continuous] [...]

Serves a Poisson request stream.  ``--split auto`` runs the HeteroEdge
loop: time a probe slice, fit the Eq. 1-3 polynomials, solve for the split
(Eq. 4 on a pair, ``solve_star`` over the groups of a star), price each
spoke's offloaded slice (its prompt embeddings compacted by the
``masked_compact`` kernel, paper §VI), then divide the batch across the
topology's node groups.  With one card every group shares it; the decision
logic and accounting are the same.  Runs on the card unless ``--device
cpu``.

``--continuous`` serves through the
:class:`~repro_torch.core.topology.HeteroRuntime` session: requests stream
through fixed KV-cache slots on each node group, waves are apportioned by
the live split from ``SplitRatioController`` (EWMA-smoothed measured
timings re-solved every few waves), with the prefill spoke, prefix cache,
mobility trace and power envelope flags; ``--frontend`` puts the asyncio
multi-tenant ingress in front of it.  ``--kv-int8`` serves from an int8 KV
cache (absmax per position and head).  The vlm (``--arch internvl2-1b``) and
audio (``--arch seamless-m4t-medium``) families take each request's stubbed
patch or frame embeddings from the request stream; every engine's cache
holds the prompt, the vlm's frontend rows, ``max_new`` and 8 spare rows.

``--mesh DATAxMODEL`` serves the request stream (any family; the vlm and
audio requests with their frontend embeddings) as one SPMD program on a
(data, model) mesh of DATA x MODEL ranks, one process each, started by
``torch.distributed.run``: every rank builds the same weights from seed 0,
keeps its shard (``launch.mesh.shard_params``) and runs the sharded engine
(``ServingEngine``, or ``ContinuousServingEngine`` with ``--continuous``).
The mesh is one node group, so the split and topology flags do not apply.
Rank 0 alone prints: one JSON line with the streams and timings.  The
process group uses ``--dist-backend`` (NCCL by default on the card, gloo on
the CPU; NCCL takes one rank per card, so ranks sharing one card use gloo).
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import datetime
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.core as C
from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.data.pipeline import request_stream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import resolve_use_kernels
from repro_torch.models import model as M
from repro_torch.models.layers import embed_apply
from repro_torch.serving.engine import ServeRequest, ServingEngine

# share of the offloaded slice's prompt tokens the §VI masking keeps when it
# prices the link payload (the value examples/serve_offload.py uses)
KEEP_RATE = 0.72
# requests in the slice that ``--split auto`` times before it solves
PROBE_REQUESTS = 2


def parse_tenants(spec: str) -> Dict[str, C.TenantClass]:
    """``--tenants`` parser: a comma list of
    ``name[:priority[:weight[:deadline_s]]]`` classes, e.g. the default
    ``interactive:0:2:0.5,batch:1:1`` — priority 0 preempts the admission
    queue (tightest TTFT deadline class), weight sets the weighted-deficit
    fair share, deadline_s the class's TTFT target."""
    tenants: Dict[str, C.TenantClass] = {}
    for part in spec.split(","):
        bits = [b.strip() for b in part.strip().split(":")]
        if not bits[0]:
            raise argparse.ArgumentTypeError(
                f"--tenants entry {part!r} has no name")
        tenants[bits[0]] = C.TenantClass(
            bits[0],
            priority=int(bits[1]) if len(bits) > 1 else 1,
            weight=float(bits[2]) if len(bits) > 2 else 1.0,
            deadline_s=float(bits[3]) if len(bits) > 3 else float("inf"))
    return tenants


def parse_split(value: str) -> Tuple[str, Optional[float]]:
    """(mode, r) with mode in {"auto", "none", "fixed"}: "auto" -> solver
    decides (r None); "none" -> all local (r 0.0); a float -> fixed ratio
    clipped to [0, 1]."""
    v = value.strip().lower()
    if v == "auto":
        return "auto", None
    if v == "none":
        return "none", 0.0
    try:
        return "fixed", float(np.clip(float(v), 0.0, 1.0))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f'--split must be "auto", "none" or a float, got {value!r}')


def partition_devices(devs: list, nodes: int) -> list:
    """Split the device list into ``nodes`` contiguous groups covering
    every device; with fewer devices than groups they share device 0."""
    if len(devs) < nodes:
        return [list(devs[g:g + 1] or devs[:1]) for g in range(nodes)]
    base, rem = divmod(len(devs), nodes)
    slices, lo = [], 0
    for g in range(nodes):
        hi = lo + base + (1 if g < rem else 0)
        slices.append(list(devs[lo:hi]))
        lo = hi
    return slices


def build_topology(kind: str = "pair", nodes: int = 2,
                   prefill_group: Optional[int] = None,
                   device: DeviceLike = None) -> C.Topology:
    """Partition the cards (all of them for ``device`` "cuda" without an
    index, else the one device) into ``nodes`` groups; with fewer cards
    than groups they share the first.  The hub gets the Nano-class
    profile, spokes the Xavier-class one (the paper's testbed asymmetry).

    ``prefill_group`` (a spoke's group index, 1..nodes-1) dedicates that
    spoke to disaggregated prefill: it takes no decode waves, shadow
    prefills ship there and their KV blocks splice back over the edge's
    link.  On a pair this is pure disaggregation: the hub does all
    decoding."""
    if nodes < 2:
        raise ValueError("--nodes must be >= 2 (hub + at least one spoke)")
    if kind == "pair" and nodes != 2:
        raise ValueError("--topology pair implies --nodes 2")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [device]
    slices = partition_devices(devs, nodes)
    hub = C.NodeGroup("primary", slices[0], C.JETSON_NANO)
    spokes = [C.NodeGroup(f"auxiliary{g}" if nodes > 2 else "auxiliary",
                          slices[g], C.JETSON_XAVIER)
              for g in range(1, nodes)]
    if kind == "pair":
        topo = C.Topology.pair(hub, spokes[0], C.WIFI_5GHZ)
        if prefill_group is not None:
            topo = dataclasses.replace(topo, prefill_spoke=prefill_group)
        return topo
    return C.Topology.star(hub, spokes, C.WIFI_5GHZ,
                           prefill_spoke=prefill_group)


def price_payload(params, cfg, prompts: np.ndarray, *,
                  device: torch.device) -> Dict[str, Any]:
    """Paper §VI on the offloaded slice: embed its prompts, keep the
    ``KEEP_RATE`` most salient tokens per request and compact them (the
    ``masked_compact`` kernel on the card).  The compacted rows plus their
    int32 indices are what crosses the link."""
    tokens = torch.as_tensor(prompts, device=device)
    with torch.no_grad():
        emb = embed_apply(params["embed"], tokens)             # [n, P, d]
        mask = C.make_mask(C.norm_scores(emb), KEEP_RATE)
        _, _, count = C.compress_tokens(
            emb, mask, capacity=prompts.shape[1],
            use_kernels=resolve_use_kernels("auto", device))
    rep = C.compression_report(mask, prompts.shape[1], cfg.d_model,
                               bytes_per_el=emb.element_size())
    return {"kept_tokens": rep.kept_tokens, "total_tokens": rep.total_tokens,
            "kept_tokens_compacted": int(count.sum()),
            "bytes_before": rep.bytes_before, "bytes_after": rep.bytes_after,
            "bandwidth_saving": rep.bandwidth_saving}


def _pad_prompt(prompt, P: int) -> np.ndarray:
    """The first ``P`` tokens of ``prompt``, zero-padded to ``P`` (int32)."""
    return np.pad(prompt[:P], (0, max(0, P - len(prompt)))).astype(np.int32)


def _serve_requests(cfg, reqs, prompt_len: int, max_new: int):
    """The engine's requests: each prompt padded to ``prompt_len``, each
    request keeping its own completion length (capped at ``max_new``) --
    mixed lengths are exactly what the slot engine absorbs."""
    return [ServeRequest(uid=r.uid, prompt=_pad_prompt(r.prompt, prompt_len),
                         max_new=max(1, min(r.max_new_tokens, max_new)),
                         frontend=r.frontend, task=cfg.name)
            for r in reqs]


def serve_static(cfg, params, reqs, *, prompt_len: int, max_new: int,
                 macro_steps: int, split: str, device: torch.device,
                 topology: Optional[C.Topology] = None) -> Dict[str, Any]:
    """Serve ``reqs`` as one static batch through the HeteroEdge split
    across ``topology`` (default: the pair); returns a summary (tokens, the
    split, timings, per-group counts, each spoke's §VI payload, the decode
    steps and prefills, one per ``generate()`` call, that every engine of
    the run took, and each engine's decode wall per step, in ms, in the
    order the engines ran)."""
    topology = topology or build_topology("pair", 2, device=device)
    G = len(topology)
    P = prompt_len
    prompts = np.stack([_pad_prompt(r.prompt, P) for r in reqs])
    B = prompts.shape[0]
    batch = {"tokens": prompts}
    engines: List[ServingEngine] = []
    ms_per_step: List[float] = []

    if cfg.frontend:
        batch["frontend"] = np.stack([r.frontend for r in reqs])
    max_len = P + M.frontend_offset(cfg) + max_new + 8

    def serve_task(b):
        eng = ServingEngine(cfg, params, max_len=max_len,
                            macro_steps=macro_steps, device=device)
        engines.append(eng)
        res = eng.generate(np.asarray(b["tokens"]), max_new=max_new,
                           frontend=b.get("frontend"))
        ms_per_step.append(1e3 * res.decode_s / max(eng.decode_steps, 1))
        return res.tokens

    summary: Dict[str, Any] = {"arch": cfg.name, "requests": B,
                               "prompt_len": P, "max_new": max_new,
                               "topology": topology.kind, "groups": G}
    mode, fixed_r = parse_split(split)
    if mode == "none":
        t0 = time.perf_counter()
        toks = serve_task(batch)
        wall = time.perf_counter() - t0
        print(f"local-only: {toks.shape} in {wall:.2f}s "
              f"({B * max_new / wall:.1f} tok/s)")
        summary.update(tokens=toks, r=0.0, wall_s=wall,
                       tokens_per_s=B * max_new / wall,
                       decode_steps=sum(e.decode_steps for e in engines),
                       prefills=len(engines), ms_per_decode_step=ms_per_step)
        return summary

    if mode == "auto":
        # calibrate on a probe slice, synthesize profiles, solve
        t0 = time.perf_counter()
        serve_task({k: v[:PROBE_REQUESTS] for k, v in batch.items()})
        probe = time.perf_counter() - t0
        aux_p, pri_p, off_p = (C.MeasuredProfile(n) for n in ("a", "p", "o"))
        for r in (0.0, 0.3, 0.5, 0.7, 1.0):
            aux_p.add(r, probe * r, 6 * r, 50 * r)
            pri_p.add(r, probe * (1 - r) * 2.2, 5, 60 * (1 - r) + 15)
            off_p.add(r, 0.01 * r * B, 0, 0)
        models = C.fit_profiles(aux_p, pri_p, off_p)
        summary["probe_s"] = probe
        if G == 2:
            res = C.solve_split_ratio(
                models, C.SolverConstraints(tau=probe * 2.2 * B / 2))
            split_r = res.r_opt
            split_v = C.SplitVector.from_r(split_r)
            summary.update(r_star=res.r_opt, t_predicted_s=res.t_opt)
            print(f"solver: r* = {res.r_opt:.2f} (predicted T "
                  f"{res.t_opt:.2f}s, probe {probe:.2f}s)")
        else:
            fn = C.group_times_from_fits(models.T2,
                                         [(models.T1, models.T3)] * (G - 1))
            t0 = time.perf_counter()
            f_opt, t_opt = C.solve_star(fn, G)
            summary["solve_star_ms"] = 1e3 * (time.perf_counter() - t0)
            split_v = C.SplitVector(tuple(f_opt))
            summary.update(f_star=list(split_v.fractions), r_star=split_v.r,
                           t_predicted_s=t_opt)
            print(f"solve_star: f* = {[f'{x:.2f}' for x in split_v.fractions]}"
                  f" (predicted makespan {t_opt:.2f}s, probe {probe:.2f}s)")
    else:
        split_r = fixed_r
        split_v = C.SplitVector.from_r(fixed_r, G)

    # each spoke's slice (spokes take the front of the batch in topology
    # order) is priced through the §VI masked payload
    counts = split_v.counts(B)
    payload = float(P * cfg.d_model * cfg.torch_dtype.itemsize)
    by_group, lo = {}, 0
    for g in range(1, G):
        if counts[g]:
            by_group[topology.groups[g].name] = price_payload(
                params, cfg, prompts[lo:lo + counts[g]], device=device)
        lo += counts[g]
    if by_group:
        comp = {k: sum(c[k] for c in by_group.values())
                for k in ("kept_tokens", "total_tokens",
                          "kept_tokens_compacted", "bytes_before",
                          "bytes_after")}
        comp["bandwidth_saving"] = 1.0 - comp["bytes_after"] \
            / max(comp["bytes_before"], 1.0)
        payload = comp["bytes_after"] / (B - counts[0])
        summary.update(compression=comp, compression_by_group=by_group)
        print(f"masking: {comp['kept_tokens']}/{comp['total_tokens']} "
              f"offloaded tokens kept -> {comp['bandwidth_saving']:.0%} "
              "bandwidth saved on the offload links")

    eng = C.OffloadEngine(serve_task, topology=topology,
                          payload_bytes_per_item=payload, jit=False)
    t0 = time.perf_counter()
    rep = eng.run(batch, split_v if G > 2 else split_r)
    wall = time.perf_counter() - t0
    per_group = " ".join(f"{n}={c}" for n, c in zip(rep.group_names, rep.n_group))
    print(f"r={rep.r:.2f} [{per_group}]  T_parallel={rep.t_parallel:.2f}s "
          f"T_serial={rep.t_serial:.2f}s link={rep.t_offload_s * 1e3:.1f}ms "
          f"({B * max_new / wall:.1f} tok/s)")
    summary.update(
        tokens=rep.outputs, r=rep.r, split=list(split_v.fractions),
        group_names=rep.group_names, n_group=rep.n_group,
        t_group_s=rep.t_group_s, t_parallel_s=rep.t_parallel,
        t_serial_s=rep.t_serial, t_offload_s=rep.t_offload_s,
        payload_bytes_per_item=payload, wall_s=wall,
        tokens_per_s=B * max_new / wall,
        decode_steps=sum(e.decode_steps for e in engines),
        prefills=len(engines), ms_per_decode_step=ms_per_step)
    summary.setdefault("r_star", None)
    return summary


def serve_continuous(cfg, params, reqs, *, prompt_len: int, max_new: int,
                     slots: int, split: str, macro_steps: int = 8,
                     wave_steps: int = 1,
                     overlap_admission: bool = True,
                     topology: Optional[C.Topology] = None,
                     link=None, telemetry_path: Optional[str] = None,
                     prefix_cache_blocks: int = 0,
                     prefix_block_size: int = 8, prefill_pool: int = 1,
                     kv_keep_rate: Optional[float] = None,
                     link_trace: Optional[str] = None,
                     mobility_beta: Optional[float] = None,
                     frontend: bool = False,
                     tenants: Optional[Dict[str, C.TenantClass]] = None,
                     queue_depth: int = 64,
                     shed_depth: Optional[int] = None,
                     power_budget_wh: Optional[float] = None,
                     power_threshold_w: float = 8.0,
                     device: DeviceLike = None):
    """Continuous-batching collaborative serving over a request stream,
    through the HeteroRuntime session (pair or star topology).

    Requests arrive in waves; each wave is apportioned across the node
    groups by the live SplitVector, every group's slot engine drains its
    share, and the measured wave timings feed the online controller that
    re-solves the split for the next wave.  Each engine's cache holds the
    prompt, a VLM's frontend tokens, ``max_new`` and 8 spare rows.  Returns
    the ``ServeResult``; with ``frontend`` the ingress's telemetry with
    every accepted request's collected stream, keyed by the request's uid,
    and the refusal count."""
    topology = topology or build_topology("pair", 2, device=device)
    if link is not None:
        topology = dataclasses.replace(
            topology, links=[None] + [link] * (len(topology) - 1))
    max_len = prompt_len + M.frontend_offset(cfg) + max_new + 8
    traces = None
    if link_trace:
        # one trace broadcast to every spoke edge: LinkTrace is a pure
        # function of the wave index, so sharing the object is safe
        tr = C.LinkTrace.from_spec(link_trace, beta=mobility_beta)
        traces = {gi: tr for gi in range(1, len(topology))}
    budgets = None
    if power_budget_wh is not None:
        # one battery-style power envelope per decode group: the serving
        # wall drains it (Eqs. 5-6) and hot groups mask out of the split
        budgets = {topology.groups[gi].name: C.GroupBudget(
                       battery=C.BatteryState(capacity_wh=power_budget_wh),
                       power_threshold_w=power_threshold_w)
                   for gi in topology.decode_indices()}
    runtime = C.HeteroRuntime(topology, slots=slots, max_len=max_len,
                              macro_steps=macro_steps,
                              wave_steps=wave_steps,
                              overlap_admission=overlap_admission,
                              prefix_cache_blocks=prefix_cache_blocks,
                              prefix_block_size=prefix_block_size,
                              prefill_pool=prefill_pool,
                              kv_keep_rate=kv_keep_rate,
                              link_traces=traces,
                              group_budgets=budgets)
    runtime.add_task(cfg.name, cfg, params,
                     max_new=max_new,
                     payload_bytes_per_item=prompt_len * cfg.d_model * 2)
    mode, fixed_r = parse_split(split)

    requests = _serve_requests(cfg, reqs, prompt_len, max_new)
    if frontend:
        # asyncio ingress in front of the same runtime: tenant-fair
        # admission waves, streamed tokens, power/memory shedding
        tenants = tenants or parse_tenants("interactive:0:2:0.5,batch:1:1")
        fe = C.ServingFrontend(runtime, tenants, queue_depth=queue_depth,
                               shed_depth=shed_depth,
                               split=None if mode == "auto" else fixed_r)
        runtime.warmup(requests[:2])
        tnames = sorted(tenants)

        async def drive():
            await fe.start()
            streams, refused = {}, 0
            for i, req in enumerate(requests):
                try:
                    streams[req.uid] = await fe.submit(
                        req.prompt, req.max_new,
                        tenant=tnames[i % len(tnames)], task=cfg.name,
                        frontend=req.frontend)
                except C.FrontendError:
                    refused += 1   # typed backpressure/shed refusal
            tokens = {uid: await s.collect() for uid, s in streams.items()}
            await fe.stop()
            return tokens, refused

        tokens, refused = asyncio.run(drive())
        tel = fe.telemetry()
        print(f"frontend[{topology.kind}]: {tel['waves_served']} waves, "
              f"{refused} refused (queue/shed), "
              f"queue_depth={tel['queue_depth']} "
              f"shed_depth={tel['shed_depth']}")
        for name, ts in tel["tenants"].items():
            print(f"  tenant {name}: {ts['completed']}/{ts['submitted']} "
                  f"done, shed={ts['shed']} "
                  f"ttft p50/p99={ts['ttft_p50_s'] * 1e3:.1f}/"
                  f"{ts['ttft_p99_s'] * 1e3:.1f}ms "
                  f"itl p50/p99={ts['itl_p50_s'] * 1e3:.2f}/"
                  f"{ts['itl_p99_s'] * 1e3:.2f}ms")
        if telemetry_path:
            with open(telemetry_path, "w") as fh:
                json.dump({"frontend": tel}, fh, indent=2)
            print(f"telemetry -> {telemetry_path}")
        return {"frontend": tel, "streams": tokens, "refused": refused}

    result = runtime.serve(requests, wave=2 * slots * (len(topology) - 1),
                           split=None if mode == "auto" else fixed_r,
                           verbose=True)
    tot = result.telemetry["totals"]
    print(f"continuous[{topology.kind}]: {tot['requests']} requests, "
          f"{tot['tokens']} tokens in {tot['wall_s']:.2f}s "
          f"({tot['tok_per_s']:.1f} tok/s), "
          f"final split={tot['final_split']}, "
          f"{tot['host_syncs']} host syncs "
          f"({tot['host_syncs_per_token']:.3f}/token, K={macro_steps}), "
          f"{tot['admission_stalls']} admission stalls"
          f"{' (overlapped)' if overlap_admission else ''}")
    if result.telemetry.get("prefill_group"):
        print(f"disaggregated prefill[{result.telemetry['prefill_group']}]: "
              f"{tot['prefill_offloaded']} offloaded, "
              f"{tot['t_kv_transfer_s'] * 1e3:.2f}ms kv-transfer, "
              f"{tot['prefill_fallbacks']} fallbacks")
    if tot.get("wave_requeued") or tot.get("mobility_latched"):
        print(f"fault domain: {tot['wave_requeued']} re-queued, "
              f"{tot['wave_retries']} retried, "
              f"{tot['mobility_latched']} mobility latches, "
              f"alive={tot['group_alive']}")
    if tot.get("admission_rerouted"):
        print(f"admission: {tot['admission_rerouted']} re-routed off "
              f"budget-hot groups, hot={tot['admission_hot']}, "
              f"power headroom={tot['power_headroom_w']}")
    if prefix_cache_blocks > 0:
        print(f"prefix cache[{prefix_cache_blocks}x{prefix_block_size}]: "
              f"{tot['prefix_hits']} hits, "
              f"{tot['prefix_blocks_reused']} blocks reused, "
              f"{tot['prefill_flops_avoided_frac']:.1%} prefill flops "
              f"avoided, kv hop {tot['kv_hop_bytes_raw'] / 1e3:.0f}kB raw "
              f"-> {tot['kv_hop_bytes_wire'] / 1e3:.0f}kB wire")
    if telemetry_path:
        with open(telemetry_path, "w") as fh:
            fh.write(result.to_json(indent=2))
        print(f"telemetry -> {telemetry_path}")
    return result


def parse_mesh(value: str) -> Tuple[int, int]:
    """``--mesh`` parser: "DATAxMODEL" -> (data, model)."""
    try:
        data, model = (int(v) for v in value.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh must be DATAxMODEL, e.g. 1x2, got {value!r}")
    if data < 1 or model < 1:
        raise argparse.ArgumentTypeError(f"--mesh {value!r}: sizes must be >= 1")
    return data, model


def _request_stream(cfg, args):
    """The launcher's requests from seed 0, with the config's stubbed
    frontend embeddings (vlm patches, audio frames) when it has one."""
    return request_stream(cfg.vocab_size, n=args.requests,
                          mean_prompt=args.prompt_len, seed=0,
                          frontend_tokens=cfg.frontend_tokens,
                          frontend_dim=(cfg.frontend_dim or cfg.d_model)
                          if cfg.frontend else 0)


def serve_mesh(ap, args) -> Optional[Dict[str, Any]]:
    """``--mesh``: this rank's part of the SPMD serving program.  Returns
    the result on rank 0 (which prints it as one JSON line), None on the
    other ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import GROUP_TIMEOUT_S, Mesh, shard_params
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.serving.engine import ContinuousServingEngine

    not_on_mesh = {"--topology star": args.topology != "pair",
                   "--nodes": args.nodes is not None,
                   "--split": args.split is not None,
                   "--prefill-group": args.prefill_group is not None,
                   "--prefix-cache-blocks": bool(args.prefix_cache_blocks),
                   "--link-trace": args.link_trace is not None,
                   "--frontend": args.frontend,
                   "--power-budget-wh": args.power_budget_wh is not None,
                   "--wave-steps": args.wave_steps > 1,
                   "--kv-int8": args.kv_int8}
    bad = [flag for flag, given in not_on_mesh.items() if given]
    if bad:
        ap.error(f"--mesh serves one node group as one SPMD program; "
                 f"{', '.join(bad)} do not apply")
    try:
        data, model = parse_mesh(args.mesh)
    except argparse.ArgumentTypeError as e:
        ap.error(str(e))
    if "WORLD_SIZE" not in os.environ:
        ap.error("--mesh runs under torch.distributed.run, one process per "
                 "rank (WORLD_SIZE is not set)")
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != data * model:
            ap.error(f"--mesh {args.mesh} needs {data * model} ranks, "
                     f"torch.distributed.run started {world}")
        mesh = Mesh(np.arange(world).reshape(data, model), ("data", "model"))
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
        params = shard_params(M.init_params(cfg, 0, device=device), mesh)
        reqs = _request_stream(cfg, args)
        P = args.prompt_len
        max_len = P + M.frontend_offset(cfg) + args.max_new + 8
        out: Dict[str, Any] = {"arch": cfg.name, "mesh": dict(mesh.shape),
                               "backend": backend, "device": str(device),
                               "requests": len(reqs), "prompt_len": P}
        with activation_sharding(mesh):
            if args.continuous:
                eng = ContinuousServingEngine(
                    cfg, params, slots=args.slots, max_len=max_len,
                    macro_steps=args.macro_steps,
                    overlap_admission=args.overlap_admission, device=device)
                outs, st = eng.run(_serve_requests(cfg, reqs, P,
                                                   args.max_new))
                out.update(mode="continuous", slots=args.slots,
                           tokens={o.uid: o.tokens.tolist() for o in outs},
                           tokens_per_s=st.tokens_per_s,
                           decode_steps=st.decode_steps,
                           decode_s=st.decode_s, prefill_s=st.prefill_s)
            else:
                eng = ServingEngine(cfg, params, max_len=max_len,
                                    macro_steps=args.macro_steps,
                                    device=device)
                res = eng.generate(
                    np.stack([_pad_prompt(r.prompt, P) for r in reqs]),
                    max_new=args.max_new,
                    frontend=np.stack([r.frontend for r in reqs])
                    if cfg.frontend else None)
                out.update(mode="static", tokens=res.tokens.tolist(),
                           tokens_per_s=res.tokens_per_s,
                           decode_steps=eng.decode_steps,
                           decode_s=res.decode_s, prefill_s=res.prefill_s)
        if rank != 0:
            return None
        print(json.dumps(out), flush=True)
        return out
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` and serve.  Returns the static path's summary dict,
    the continuous path's ``ServeResult``, or (``--frontend``) the
    ingress's telemetry with the collected streams."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_configs(), default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (absmax per position and head)")
    ap.add_argument("--split", default=None,
                    help='"auto" (HeteroEdge solver, the default), a float r, '
                         'or "none"')
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching runtime")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache slots per node group (continuous mode)")
    ap.add_argument("--macro-steps", type=int, default=8,
                    help="fused decode tokens per dispatch (0 = per-token loop)")
    ap.add_argument("--wave-steps", type=int, default=1,
                    help="fused macro-steps per host launch (>1 = the wave "
                         "driver; requires --macro-steps > 0)")
    ap.add_argument("--overlap-admission", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="prefill newly admitted requests into shadow slots "
                         "behind the in-flight decode macro-step "
                         "(--no-overlap-admission = boundary-blocking "
                         "admission for A/B)")
    ap.add_argument("--topology", choices=("pair", "star"), default="pair",
                    help="2-node pair (paper) or §VIII star")
    ap.add_argument("--nodes", type=int, default=None,
                    help="total node groups (default 2 for pair, 3 for star)")
    ap.add_argument("--prefill-group", type=int, default=None,
                    metavar="SPOKE",
                    help="dedicate spoke SPOKE (group index 1..) to "
                         "disaggregated prefill: shadow prefills ship "
                         "there and KV blocks splice back over its link "
                         "(continuous mode; requires --macro-steps > 0)")
    ap.add_argument("--prefix-cache-blocks", type=int, default=0,
                    metavar="N",
                    help="arm the cross-request radix prefix cache with a "
                         "budget of N KV blocks per task (0 = disabled; "
                         "continuous mode)")
    ap.add_argument("--prefix-block-size", type=int, default=8,
                    metavar="T", help="prefix-cache block size in tokens")
    ap.add_argument("--prefill-pool", type=int, default=1, metavar="W",
                    help="prefill workers on the dedicated prefill group "
                         "(>1 = content-hash affinity pool with failover; "
                         "requires --prefill-group)")
    ap.add_argument("--kv-keep-rate", type=float, default=None,
                    metavar="R",
                    help="LOSSY prefill->decode KV-hop compression: keep "
                         "only the top-R salience fraction of shipped tail "
                         "rows (default off = lossless compaction)")
    ap.add_argument("--link-trace", default=None, metavar="SPEC",
                    help="mobility trace replayed per serve wave on every "
                         "spoke edge: comma-separated distances in meters "
                         '("4,12,28,12,4") or @path to a JSON file with '
                         "distances/bandwidths arrays (continuous mode); "
                         "edges whose fitted latency L(d) crosses beta are "
                         "latched local until the trace re-opens them")
    ap.add_argument("--mobility-beta", type=float, default=None,
                    metavar="B",
                    help="latency threshold beta (s) for the --link-trace "
                         "stop-offloading latch (default: MobilityModel's)")
    ap.add_argument("--telemetry-json", default=None, metavar="PATH",
                    help="write HeteroRuntime telemetry JSON here")
    ap.add_argument("--frontend", action="store_true",
                    help="serve through the asyncio multi-tenant ingress "
                         "(streamed tokens, tenant-fair admission waves, "
                         "power/memory shedding; requires --continuous)")
    ap.add_argument("--tenants", default="interactive:0:2:0.5,batch:1:1",
                    metavar="SPEC",
                    help="comma list of name[:priority[:weight"
                         "[:deadline_s]]] tenant classes; requests round-"
                         "robin across them (frontend mode)")
    ap.add_argument("--queue-depth", type=int, default=64, metavar="N",
                    help="bounded admission queue: submissions beyond N "
                         "queued requests are refused (backpressure)")
    ap.add_argument("--shed-depth", type=int, default=None, metavar="N",
                    help="queued requests admitted while the WHOLE "
                         "fleet's power/memory budget is hot before the "
                         "ingress sheds (default: --slots)")
    ap.add_argument("--power-budget-wh", type=float, default=None,
                    metavar="WH",
                    help="arm a battery-style power envelope of WH "
                         "watt-hours on every decode group (Eqs. 5-6): "
                         "serving drains it, hot groups re-route via the "
                         "masked split (continuous mode)")
    ap.add_argument("--power-threshold-w", type=float, default=8.0,
                    metavar="W",
                    help="P_available floor (W) under the power envelope")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; raises without a card) or "cpu"')
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve as one SPMD program on a (data, model) mesh "
                         "of ranks; run under torch.distributed.run with "
                         "DATA x MODEL processes")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend for --mesh (default nccl on "
                         "the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        return serve_mesh(ap, args)
    args.split = args.split or "auto"
    nodes = args.nodes or (2 if args.topology == "pair" else 3)

    if args.prefill_group is not None and not args.continuous:
        ap.error("--prefill-group requires --continuous (disaggregated "
                 "prefill rides the continuous overlapped-admission path)")
    if args.prefix_cache_blocks and not args.continuous:
        ap.error("--prefix-cache-blocks requires --continuous (the radix "
                 "cache lives in the slot runtime's admission loop)")
    if args.prefill_pool > 1 and args.prefill_group is None:
        ap.error("--prefill-pool > 1 requires --prefill-group (the pool "
                 "lives on the dedicated prefill spoke)")
    if (args.link_trace or args.mobility_beta is not None) \
            and not args.continuous:
        ap.error("--link-trace/--mobility-beta require --continuous (the "
                 "trace replays on the HeteroRuntime wave clock)")
    if args.mobility_beta is not None and not args.link_trace:
        ap.error("--mobility-beta only applies to a --link-trace")
    if args.wave_steps > 1 and not args.continuous:
        ap.error("--wave-steps > 1 requires --continuous (the wave driver "
                 "is the slot runtime's fused decode launcher)")
    if args.frontend and not args.continuous:
        ap.error("--frontend requires --continuous (the ingress feeds the "
                 "slot runtime at wave boundaries)")
    if args.power_budget_wh is not None and not args.continuous:
        ap.error("--power-budget-wh requires --continuous (the envelope "
                 "drains on the HeteroRuntime wave clock)")

    device = resolve_device(args.device)
    topology = build_topology(args.topology, nodes,
                              prefill_group=args.prefill_group, device=device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant="int8")
    params = M.init_params(cfg, 0, device=device)
    print(f"arch={cfg.name}{' (reduced)' if args.reduced else ''}"
          f"{' kv=int8' if args.kv_int8 else ''} "
          f"topology={args.topology}/{nodes} device={device}")
    reqs = _request_stream(cfg, args)
    if args.continuous:
        return serve_continuous(
            cfg, params, reqs, prompt_len=args.prompt_len,
            max_new=args.max_new, slots=args.slots, split=args.split,
            macro_steps=args.macro_steps, wave_steps=args.wave_steps,
            overlap_admission=args.overlap_admission, topology=topology,
            telemetry_path=args.telemetry_json,
            prefix_cache_blocks=args.prefix_cache_blocks,
            prefix_block_size=args.prefix_block_size,
            prefill_pool=args.prefill_pool, kv_keep_rate=args.kv_keep_rate,
            link_trace=args.link_trace, mobility_beta=args.mobility_beta,
            frontend=args.frontend, tenants=parse_tenants(args.tenants),
            queue_depth=args.queue_depth, shed_depth=args.shed_depth,
            power_budget_wh=args.power_budget_wh,
            power_threshold_w=args.power_threshold_w, device=device)
    return serve_static(cfg, params, reqs, prompt_len=args.prompt_len,
                        max_new=args.max_new, macro_steps=args.macro_steps,
                        split=args.split, device=device, topology=topology)


if __name__ == "__main__":
    main()
