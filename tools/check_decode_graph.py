#!/usr/bin/env python3
"""Check the fused decode loop's CUDA graphs against its eager steps on one
card, at each benchmark cell's configuration, slots and lengths.

    python3 tools/check_decode_graph.py [--cells CELL ...] [--seed N] \
        [--batches 2]

For each cell (default: every cell of ``BENCHMARK.json``) it builds what
``portbench/harness.py`` builds for a run: the configuration's weights
drawn from the seed, the pair's ``HeteroRuntime`` with the traffic's slots
and lengths, and one warm request through each group, during which the
decode loop captures its graphs.  It then serves the traffic's batches at
a fixed split of 0.5, first as graphs, then eagerly (with
``decode_graph.decode_graph_refusal`` stood in to refuse), and prints one
JSON line a cell:

- ``streams_equal``: every request's tokens of batch 0, graphs against
  eager; ``launches_equal``: ``ops.launch_counts()`` over batch 0 in both;
- per arm and batch: the wall, ``engine_ms_per_decode_step`` from the
  telemetry, the three decode-graph counters, the launch counts and
  ``memory_peak_bytes``;
- per arm, over every slot live at the prompt length: ``host_ms_per_step``
  (macro-steps back to back, the host clock after a synchronize) and
  ``device_ms_per_step`` (the kernels' device time in a profiler over two
  macro-steps);
- the warm-up's ``captures``, ``capture_s``, and the graphs' memory pool in
  ``pool_bytes``.

Exits 1 when a stream or a launch count differs.  ``--device cpu --small``
rehearses the plumbing on the CPU at ``portbench/tests/pb_small.py``'s
sizes, where the loop refuses the graphs and both arms run eagerly.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _eager(graphs):
    """The loop refuses the graphs inside the block.  The runs there make
    their own caches, so the loop's graphs and cache are dropped first."""
    from repro_torch.serving import decode_graph
    graphs._drop()
    graphs._cache = None
    real = decode_graph.decode_graph_refusal
    decode_graph.decode_graph_refusal = lambda t, use_kernels: "eager arm"
    try:
        yield
    finally:
        decode_graph.decode_graph_refusal = real


def _pool_bytes(torch, pool):
    """The bytes of the allocator's segments in the graphs' pool."""
    if pool is None or not torch.cuda.is_available():
        return None
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id") or ()) == tuple(pool))


def _time_steps(torch, eng, prompt_len: int, dev, reps: int = 3):
    """(host ms, device ms) a step over every slot live at ``prompt_len``
    rows; device ms is None off the card or where the profiler saw no
    kernel."""
    from torch.autograd import DeviceType
    with torch.no_grad():             # as in a run: the loop's own cache
        cache, cur, lengths, remaining, done = eng._init_state()
    lengths.fill_(prompt_len)
    remaining.fill_(1 << 30)
    done.zero_()
    fn, K = eng._fused(), eng.macro_steps

    def steps(n):
        for _ in range(n):
            fn(eng.params, cache, cur, lengths, remaining, done, eng._shard)
        _sync(torch, dev)

    with torch.no_grad():
        steps(1)                      # warm: the loop's cache, no capture
        t0 = time.perf_counter()
        steps(reps)
        host_ms = 1e3 * (time.perf_counter() - t0) / (reps * K)
        device_ms = None
        if dev.type == "cuda":
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                steps(2)
            us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
            device_ms = us / 1e3 / (2 * K) if us else None
    return host_ms, device_ms


def check_cell(torch, name: str, seed: int, batches: int, dev,
               small: bool) -> dict:
    from portbench import harness
    from portbench import traffic as traffic_mod
    from portbench.families import common
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeRequest

    pb = ROOT / "portbench"
    cell = harness.cell_of(harness.load_bench(ROOT), name)
    config = json.loads((pb / "configs" / f"{cell['config']}.json")
                        .read_text())
    mix = traffic_mod.load_mix(pb, cell["traffic"])
    if small:
        sys.path.insert(0, str(pb / "tests"))
        import pb_small
        config.update(pb_small.CONFIGS[name])
        mix.update(pb_small.MIX)
    sizes = common.sizes(config)
    port_cfg = harness.port_config(config)
    params = harness.family(pb, config["family"]).make_params(sizes, seed,
                                                              dev)
    gen = traffic_mod.Generator(mix, sizes.vocab_size, seed)
    runtime = harness.build_runtime(port_cfg, params, mix, dev)

    def serve_requests(reqs):
        return [ServeRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                             task=port_cfg.name) for r in reqs]

    t0 = time.perf_counter()
    runtime.warmup(serve_requests([gen.warm()]))
    _sync(torch, dev)
    eng = next(iter(runtime.tasks[port_cfg.name].engines.values()))
    graphs = eng._fused().graphs
    out = {"cell": name, "seed": seed, "warmup_s": time.perf_counter() - t0,
           "captures": graphs.captures, "capture_s": graphs.capture_s,
           "pool_bytes": _pool_bytes(torch, graphs.pool), "arms": {}}
    K = mix["runtime"]["macro_steps"]
    streams = {}
    for arm in ("graphs", "eager"):
        rows = []
        with _eager(graphs) if arm == "eager" else contextlib.nullcontext():
            for b in range(batches if arm == "graphs" else 1):
                ops.reset_launch_counts()
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                res = runtime.serve(serve_requests(gen.batch(b)), split=0.5,
                                    warm=False)
                _sync(torch, dev)
                tot = res.telemetry["totals"]
                if b == 0:
                    streams[arm] = {o.uid: [int(x) for x in o.tokens]
                                    for outs in res.outputs.values()
                                    for o in outs}
                rows.append({
                    "batch": b, "wall_s": time.perf_counter() - t0,
                    "engine_ms_per_decode_step":
                        1e3 * tot["t_per_macro_step_s"] / K,
                    **{k: tot[k] for k in ("decode_graph_steps",
                                           "decode_eager_steps",
                                           "decode_graph_captures")},
                    "launches": ops.launch_counts(),
                    "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None})
            host_ms, device_ms = _time_steps(torch, eng, mix["prompt_len"],
                                             dev)
        out["arms"][arm] = {"batches": rows, "host_ms_per_step": host_ms,
                            "device_ms_per_step": device_ms}
    g, e = streams["graphs"], streams["eager"]
    out["requests"] = len(e)
    out["streams_equal"] = g == e
    out["streams_differing"] = sorted(u for u in e if g.get(u) != e[u])[:16]
    out["launches_equal"] = (out["arms"]["graphs"]["batches"][0]["launches"]
                             == out["arms"]["eager"]["batches"][0]["launches"])
    out["captures_after_warmup"] = graphs.captures - out["captures"]
    del runtime, params, eng, graphs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+")
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    from portbench import run as pb_run
    pb_run.prepare()
    import gc

    import torch
    from portbench import harness

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("check_decode_graph: no CUDA device", file=sys.stderr)
            return 2
        torch.cuda.set_device(dev)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(json.dumps({"card": smi, "torch": torch.__version__,
                          "cuda": torch.version.cuda}), flush=True)
    cells = args.cells or [w["name"] for w in
                           harness.load_bench(ROOT)["workloads"]]
    ok = True
    for name in cells:
        res = check_cell(torch, name, args.seed, args.batches, dev,
                         args.small)
        ok = ok and res["streams_equal"] and res["launches_equal"]
        print(json.dumps(res), flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
