"""Serving launcher with HeteroEdge collaborative offloading (static batches).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 16 --prompt-len 128 --max-new 32 [--reduced] \
        [--split auto|none|<r>] [--macro-steps 8] [--device cuda|cpu]

Serves a Poisson request stream as one static batch.  ``--split auto``
runs the HeteroEdge loop: time a probe slice, fit the Eq. 1-3 polynomials,
solve Eq. 4 for r*, price the offloaded slice's payload (its prompt
embeddings compacted by the ``masked_compact`` kernel, paper §VI), then
split the batch between the primary and the auxiliary node group.  With
one card both groups share it; the decision logic and accounting are the
same.  Runs on the card unless ``--device cpu``.

The continuous-batching runtime, the star topology and the int8 KV cache
are not ported yet: their flags exit with "not ported yet".
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.core as C
from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.data.pipeline import request_stream
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import resolve_use_kernels
from repro_torch.models import model as M
from repro_torch.models.layers import embed_apply
from repro_torch.serving.engine import ServingEngine

# flags of the JAX launcher whose paths this port does not have yet
_NOT_PORTED_SWITCHES = ("--continuous", "--kv-int8", "--frontend")
_NOT_PORTED_VALUES = ("--slots", "--wave-steps", "--prefill-group",
                      "--prefix-cache-blocks", "--prefix-block-size",
                      "--prefill-pool", "--kv-keep-rate", "--link-trace",
                      "--mobility-beta", "--telemetry-json", "--tenants",
                      "--queue-depth", "--shed-depth", "--power-budget-wh",
                      "--power-threshold-w")

# share of the offloaded slice's prompt tokens the §VI masking keeps when it
# prices the link payload (the value examples/serve_offload.py uses)
KEEP_RATE = 0.72
# requests in the slice that ``--split auto`` times before it solves Eq. 4
PROBE_REQUESTS = 2


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


def build_topology(device: torch.device) -> C.Topology:
    """The paper's pair: hub gets the Nano-class profile, the spoke the
    Xavier-class one (the testbed's asymmetry)."""
    if device.type == "cuda" and device.index is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [device]
    slices = partition_devices(devs, 2)
    return C.Topology.pair(C.NodeGroup("primary", slices[0], C.JETSON_NANO),
                           C.NodeGroup("auxiliary", slices[1], C.JETSON_XAVIER),
                           C.WIFI_5GHZ)


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


def serve_static(cfg, params, reqs, *, prompt_len: int, max_new: int,
                 macro_steps: int, split: str,
                 device: torch.device) -> Dict[str, Any]:
    """Serve ``reqs`` as one static batch through the HeteroEdge split;
    returns a summary (tokens, r*, timings, per-group counts, and the
    decode steps and prefills, one per ``generate()`` call, that every
    engine of the run took)."""
    P = prompt_len
    prompts = np.stack([np.pad(r.prompt[:P], (0, max(0, P - len(r.prompt))))
                        for r in reqs]).astype(np.int32)
    B = prompts.shape[0]
    batch = {"tokens": prompts}
    engines: List[ServingEngine] = []

    def serve_task(b):
        eng = ServingEngine(cfg, params, max_len=P + max_new + 8,
                            macro_steps=macro_steps, device=device)
        engines.append(eng)
        return eng.generate(np.asarray(b["tokens"]), max_new=max_new).tokens

    summary: Dict[str, Any] = {"arch": cfg.name, "requests": B,
                               "prompt_len": P, "max_new": max_new}
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
                       prefills=len(engines))
        return summary

    r_star = None
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
        res = C.solve_split_ratio(
            C.fit_profiles(aux_p, pri_p, off_p),
            C.SolverConstraints(tau=probe * 2.2 * B / 2))
        r_star = res.r_opt
        print(f"solver: r* = {res.r_opt:.2f} (predicted T {res.t_opt:.2f}s, "
              f"probe {probe:.2f}s)")
        summary.update(probe_s=probe, t_predicted_s=res.t_opt)
    split_r = r_star if r_star is not None else fixed_r

    n_off = C.split_sizes(B, split_r)[0]
    payload = float(P * cfg.d_model * cfg.torch_dtype.itemsize)
    if n_off:
        comp = price_payload(params, cfg, prompts[:n_off], device=device)
        payload = comp["bytes_after"] / n_off
        summary["compression"] = comp
        print(f"masking: {comp['kept_tokens']}/{comp['total_tokens']} "
              f"offloaded tokens kept -> {comp['bandwidth_saving']:.0%} "
              f"bandwidth saved on the offload link")

    eng = C.OffloadEngine(serve_task, topology=build_topology(device),
                          payload_bytes_per_item=payload, jit=False)
    t0 = time.perf_counter()
    rep = eng.run(batch, split_r)
    wall = time.perf_counter() - t0
    per_group = " ".join(f"{n}={c}" for n, c in zip(rep.group_names, rep.n_group))
    print(f"r={rep.r:.2f} [{per_group}]  T_parallel={rep.t_parallel:.2f}s "
          f"T_serial={rep.t_serial:.2f}s link={rep.t_offload_s * 1e3:.1f}ms "
          f"({B * max_new / wall:.1f} tok/s)")
    summary.update(
        tokens=rep.outputs, r_star=r_star, r=rep.r,
        group_names=rep.group_names, n_group=rep.n_group,
        t_group_s=rep.t_group_s, t_parallel_s=rep.t_parallel,
        t_serial_s=rep.t_serial, t_offload_s=rep.t_offload_s,
        payload_bytes_per_item=payload, wall_s=wall,
        tokens_per_s=B * max_new / wall,
        decode_steps=sum(e.decode_steps for e in engines),
        prefills=len(engines))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_configs(), default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--split", default="auto",
                    help='"auto" (HeteroEdge solver), a float r, or "none"')
    ap.add_argument("--macro-steps", type=int, default=8,
                    help="fused decode tokens per dispatch (0 = per-token loop)")
    ap.add_argument("--topology", choices=("pair", "star"), default="pair")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; raises without a card) or "cpu"')
    for flag in _NOT_PORTED_SWITCHES:
        ap.add_argument(flag, action="store_true", default=None,
                        help=argparse.SUPPRESS)
    ap.add_argument("--overlap-admission", default=None,
                    action=argparse.BooleanOptionalAction,
                    help=argparse.SUPPRESS)
    for flag in _NOT_PORTED_VALUES:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    for flag in _NOT_PORTED_SWITCHES + ("--overlap-admission",) + _NOT_PORTED_VALUES:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet")
    if args.topology != "pair" or args.nodes not in (None, 2):
        ap.error("--topology star / --nodes > 2 is not ported yet")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, 0, device=device)
    print(f"arch={cfg.name}{' (reduced)' if args.reduced else ''} "
          f"topology=pair/2 device={device}")
    reqs = request_stream(cfg.vocab_size, n=args.requests,
                          mean_prompt=args.prompt_len, seed=0)
    return serve_static(cfg, params, reqs, prompt_len=args.prompt_len,
                        max_new=args.max_new, macro_steps=args.macro_steps,
                        split=args.split, device=device)


if __name__ == "__main__":
    main()
