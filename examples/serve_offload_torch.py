"""End-to-end driver on the PyTorch port: collaborative serving with
HeteroEdge offloading (the twin of ``examples/serve_offload.py``).

    PYTHONPATH=src python examples/serve_offload_torch.py [--arch llama3.2-1b] \
        [--requests 24] [--device cuda|cpu]

Serves a small (reduced-config) model against a Poisson request stream, on
the card unless ``--device cpu``:
  1. profile both node groups on a calibration batch (real wall clocks),
  2. fit + solve for the split ratio,
  3. compress the offload payload with the masked_compact kernel (§VI): the
     prompts' embeddings, masked by salience, compacted on the card,
  4. run the request batches through the OffloadEngine and report latency
     at r ∈ {0, r*, 1} — the Table-III experiment on live hardware,
  5. drain the same stream through the continuous-batching runtime with
     the online SplitRatioController re-solving r from live timings,
  6. open a HeteroRuntime session on a 3-node star (§VIII) serving a mixed
     two-task stream, the per-group split re-solved by solve_star.
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.core as C
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.offload import tree_leaves
from repro_torch.data.pipeline import request_stream
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import resolve_use_kernels
from repro_torch.launch.serve import serve_continuous
from repro_torch.models import model as M
from repro_torch.models.layers import embed_apply
from repro_torch.serving.engine import ServeRequest, ServingEngine


def run(arch: str = "llama3.2-1b", n_requests: int = 24, device=None,
        params=None, params_b=None):
    """The six steps; returns what they produced: the prompts, each split's
    OffloadReport (``reports``, by r), the §VI payload (``payload``), the
    continuous run's and the star session's results.  ``params`` /
    ``params_b``: the two tasks' weights (default: seeds 0 and 7)."""
    dev = resolve_device(device)
    cfg = reduced(get_config(arch))
    params = params if params is not None else M.init_params(cfg, 0, device=dev)
    print(f"arch={cfg.name} (reduced: {cfg.num_layers}L d={cfg.d_model}) "
          f"params={sum(x.numel() for x in tree_leaves(params)):,}")

    # ---- requests ------------------------------------------------------
    P = 16
    reqs = request_stream(cfg.vocab_size, n=n_requests, mean_prompt=P,
                          seed=0, frontend_tokens=cfg.frontend_tokens,
                          frontend_dim=cfg.frontend_dim or 0)
    prompts = np.stack([
        np.pad(r.prompt[:P], (0, max(0, P - len(r.prompt)))) for r in reqs
    ]).astype(np.int32)

    def serve_task(batch):
        eng = ServingEngine(cfg, params, max_len=64, device=dev)
        fe = batch.get("frontend")
        return eng.generate(np.asarray(batch["tokens"]), max_new=8,
                            frontend=fe).tokens

    batch = {"tokens": prompts}
    if cfg.frontend:
        batch["frontend"] = np.stack([r.frontend for r in reqs])

    # ---- 1-2. profile + solve ------------------------------------------
    # calibrate: time the task on a probe slice; synthesize profiles with
    # the Jetson speed asymmetry applied (primary 2.2x slower)
    t0 = time.perf_counter()
    serve_task({k: v[:4] for k, v in batch.items()})
    probe_s = time.perf_counter() - t0
    rs = [0.0, 0.3, 0.5, 0.7, 0.8, 1.0]
    aux = C.MeasuredProfile("aux")
    pri = C.MeasuredProfile("pri")
    off = C.MeasuredProfile("off")
    for r in rs:
        aux.add(r, probe_s * r, 6.0 * r, 50 * r)
        pri.add(r, probe_s * (1 - r) * 2.2, 5.0, 70 * (1 - r) + 16)
        off.add(r, 0.02 * r * len(reqs), 0, 0)
    models = C.fit_profiles(aux, pri, off)
    res = C.solve_split_ratio(models, C.SolverConstraints(tau=probe_s * 2.2 * len(reqs) / 4))
    print(f"solver: r* = {res.r_opt:.2f}  predicted T = {res.t_opt:.2f}s")

    # ---- 3. payload compression (§VI) -----------------------------------
    tokens = torch.as_tensor(prompts, device=dev)
    with torch.no_grad():
        emb = M.forward(params, cfg, {"tokens": tokens}, mode="train").logits
        mask = C.make_mask(C.norm_scores(emb), keep_rate=0.72)
        rows = embed_apply(params["embed"], tokens)            # [B, P, d]
        packed, idx, count = C.compress_tokens(
            rows, mask, capacity=P,
            use_kernels=resolve_use_kernels("auto", dev))
    rep = C.compression_report(mask, capacity=P, d_model=cfg.d_model)
    print(f"masking: keeping {rep.keep_rate:.0%} of tokens -> "
          f"{rep.bandwidth_saving:.0%} bandwidth saved on the offload link "
          f"({int(count.sum())} rows compacted into {tuple(packed.shape)})")

    # ---- 4. run the split ------------------------------------------------
    eng = C.OffloadEngine(serve_task,
                          C.NodeGroup("primary", [dev], C.JETSON_NANO),
                          C.NodeGroup("auxiliary", [dev], C.JETSON_XAVIER),
                          C.WIFI_5GHZ,
                          payload_bytes_per_item=rep.bytes_after / len(reqs),
                          jit=False)
    reports = {}
    for r in sorted({0.0, round(res.r_opt, 2), 1.0}):
        t0 = time.perf_counter()
        out = eng.run(batch, r)
        wall = time.perf_counter() - t0
        reports[r] = out
        print(f"r={r:4.2f}  local={out.n_local:3d} offloaded={out.n_offloaded:3d}  "
              f"T_serial={out.t_serial:6.2f}s  T_parallel={out.t_parallel:6.2f}s  "
              f"(wall {wall:.2f}s, link {out.t_offload_s * 1e3:.1f}ms)")
    print("outputs shape:", tuple(out.outputs.shape))

    # ---- 5. continuous-batching runtime + online controller -------------
    # mixed completion lengths (2..8) are what the slot runtime absorbs;
    # the shared wave-dispatch loop lives in repro_torch.core.topology
    for r in reqs:
        r.max_new_tokens = 2 + (r.uid % 7)
    continuous = serve_continuous(cfg, params, reqs, prompt_len=P, max_new=8,
                                  slots=4, split="auto", device=dev)

    # ---- 6. HeteroRuntime session: star topology, two concurrent tasks --
    # the paper's headline evaluation runs multiple DNNs at once; here two
    # model instances share one session, interleaved over the same waves,
    # with solve_star apportioning each wave across hub + 2 spokes
    params_b = params_b if params_b is not None \
        else M.init_params(cfg, 7, device=dev)
    topo = C.Topology.star(
        C.NodeGroup("hub", [dev], C.JETSON_NANO),
        [C.NodeGroup("spoke1", [dev], C.JETSON_XAVIER),
         C.NodeGroup("spoke2", [dev], C.JETSON_XAVIER)],
        C.WIFI_5GHZ)
    runtime = C.HeteroRuntime(topo, slots=2, max_len=32)
    runtime.add_task("vision-a", cfg, params, max_new=6)
    runtime.add_task("vision-b", cfg, params_b, max_new=6)
    session_reqs = [
        ServeRequest(uid=i, prompt=prompts[i % len(prompts)],
                     max_new=2 + i % 5,
                     task="vision-a" if i % 2 == 0 else "vision-b")
        for i in range(16)]
    result = runtime.serve(session_reqs, verbose=True)
    tot = result.telemetry["totals"]
    print(f"star session: {tot['requests']} reqs over "
          f"{len(result.telemetry['waves'])} waves, "
          f"{tot['tokens']} toks ({tot['tok_per_s']:.1f} tok/s), "
          f"final split={tot['final_split']}")
    return {"cfg": cfg, "prompts": prompts, "reports": reports,
            "payload": (packed, idx, count, mask), "continuous": continuous,
            "session": result, "session_requests": session_reqs}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    args = ap.parse_args()
    run(args.arch, args.requests, args.device)


if __name__ == "__main__":
    main()
