"""One run of one cell: set-up, the measured window, the check that
decides ``correct``, and the metrics.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json`` (and
its family's weights and plain reference in ``families/<family>.py``),
its traffic in ``traffic/<mix>.json``, the limits of its check in
``limits/<cell>.json``, and each metric's reader in
``metrics/<metric>.py``.

The window drives ``repro_torch.core.topology.HeteroRuntime.serve`` in a
closed loop: one batch of the runtime's wave size, every request due when
the batch is submitted, and the next batch when it returns.  The window
opens at the first submission, batches are submitted while the run's
``--seconds`` have not passed, and it closes when the last batch submitted
returns: every metric reads all the work and all the time of whole
batches.  (A batch takes tens of seconds and lands its tokens in bursts;
a window cut mid-batch would count a burst in or out by the tenth of a
second.)
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from portbench import trace as trace_mod
from portbench import traffic as traffic_mod
from portbench.families import common

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# spans around the serving path's host steps, which name the device's idle
# gaps in a traced run: what the host was doing while the device waited
HOST_SPANS = {
    "runtime_serve": ("repro_torch.core.topology", "HeteroRuntime.serve"),
    "engine_run": ("repro_torch.serving.engine", "ContinuousServingEngine.run"),
    "prefill": ("repro_torch.serving.engine",
                "ContinuousServingEngine._prefill"),
    "admission": ("repro_torch.serving.engine", "admit_boundary"),
    "decode_launch": ("repro_torch.serving.engine", "_DecodeLauncher._launch"),
    "token_bookkeeping": ("repro_torch.serving.engine",
                          "ContinuousServingEngine._consume_block"),
}


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


# ---------------------------------------------------------------------------
# discovery by name
# ---------------------------------------------------------------------------
def load_bench(root: Path) -> Dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell_of(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(pb: Path, metric: str) -> ModuleType:
    """``metrics/<metric>.py``: LAYER, UNIT, MOVES, SOURCE, an optional
    SPAN (module, function) and ``read(run) -> float or None``."""
    return _load_file(Path(pb) / "metrics" / f"{metric}.py",
                      f"portbench_metric_{metric.replace('.', '_')}")


def family(pb: Path, name: str) -> ModuleType:
    return _load_file(Path(pb) / "families" / f"{name}.py",
                      f"portbench.families.{name}")


def metrics_for(bench: Dict, cell: str, traced: bool) -> List[Dict]:
    """The end-to-end metrics (untraced), or the per-layer metrics that
    list the cell (traced)."""
    if not traced:
        return bench["end_to_end"]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


# ---------------------------------------------------------------------------
# what the readers read
# ---------------------------------------------------------------------------
@dataclass
class RequestRecord:
    uid: int
    batch: int
    group: str = ""
    due: float = 0.0
    prompt_len: int = 0
    max_new: int = 0
    landings: List = field(default_factory=list)   # (host time, tokens)
    streamed: List[int] = field(default_factory=list)
    tokens: Optional[np.ndarray] = None            # the served output
    answers: int = 0                               # outputs returned


@dataclass
class Run:
    """One run's record: the readers' only input."""
    cell: Dict
    config: Dict
    sizes: object                  # the configuration's numbers
    family: ModuleType
    mix: Dict
    seconds: float                 # submissions stop after these
    setup_s: float = 0.0
    t0: float = 0.0                # the first submission
    t_end: float = 0.0             # the last batch returned: the close
    paused_s: float = 0.0          # the profiler's stop inside the window
    requests: Dict[int, RequestRecord] = field(default_factory=dict)
    telemetry: List[Dict] = field(default_factory=list)   # one a batch
    trace: Optional[trace_mod.Trace] = None
    traced_batches: set = field(default_factory=set)   # the trace holds

    @property
    def window_s(self) -> float:
        """The window's serving seconds (a traced run's profiler stop,
        between its first and second batch, left out)."""
        return self.t_end - self.t0 - self.paused_s

    @property
    def waves(self) -> List[Dict]:
        return [w for tel in self.telemetry for w in tel["waves"]]


def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile, linear between the closest ranks."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, float), q))


def ttft_s(run: Run) -> List[float]:
    """Each request due in the window: first landing - due; a request
    with no first token by the close counts at the close."""
    out = []
    for r in run.requests.values():
        if r.due > run.t_end:
            continue
        first = r.landings[0][0] if r.landings else math.inf
        out.append(min(first, run.t_end) - r.due)
    return out


def tpot_s(run: Run) -> List[float]:
    """Each request with two or more tokens landed in the window: (last -
    first landing in it) / (its tokens landed in it - 1)."""
    out = []
    for r in run.requests.values():
        land = [(t, n) for t, n in r.landings if t <= run.t_end]
        n = sum(k for _, k in land)
        if n >= 2:
            out.append((land[-1][0] - land[0][0]) / (n - 1))
    return out


def tokens_in_window(run: Run) -> int:
    return sum(n for r in run.requests.values()
               for t, n in r.landings if t <= run.t_end)


def compute_metrics(pb: Path, bench: Dict, run: Run,
                    traced: bool) -> Dict[str, Dict]:
    """Every metric of the cell that its reader finds something for."""
    out = {}
    for m in metrics_for(bench, run.cell["name"], traced):
        value = reader(pb, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def span_targets(pb: Path, bench: Dict, cell: str) -> Dict:
    """The spans the cell's per-layer readers read: name -> (module,
    function)."""
    out = {}
    for m in metrics_for(bench, cell, traced=True):
        span = getattr(reader(pb, m["name"]), "SPAN", None)
        if span:
            out[span[1]] = tuple(span)
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
def port_config(config: Dict):
    """The port's registered configuration with the file's numbers."""
    from repro_torch.configs.base import ModelConfig, get_config
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = get_config(config["arch"])
    return dataclasses.replace(cfg, **{k: v for k, v in config.items()
                                       if k in fields and k not in (
                                           "name", "family", "source")})


def build_runtime(port_cfg, params, mix: Dict, device):
    """The pair topology and the HeteroRuntime session with the
    launcher's continuous defaults (``launch/serve.py:serve_continuous``),
    the task registered."""
    from repro_torch.core.topology import HeteroRuntime
    from repro_torch.launch.serve import build_topology

    rt = mix["runtime"]
    topo = build_topology(rt["topology"], 2, device=device)
    max_new = mix["output_len"]["max"]
    runtime = HeteroRuntime(
        topo, slots=mix["slots"],
        max_len=mix["prompt_len"] + max_new + rt["spare_rows"],
        macro_steps=rt["macro_steps"], wave_steps=rt["wave_steps"],
        overlap_admission=rt["overlap_admission"],
        prefix_cache_blocks=rt["prefix_cache_blocks"])
    runtime.add_task(port_cfg.name, port_cfg, params, max_new=max_new,
                     payload_bytes_per_item=mix["prompt_len"]
                     * port_cfg.d_model * 2)
    for eng in runtime.tasks[port_cfg.name].engines.values():
        if eng.async_dispatch != rt["async_dispatch"]:
            raise ValueError("the engines' async_dispatch is not the mix's")
    return runtime


def _serve_requests(port_cfg, reqs):
    from repro_torch.serving.engine import ServeRequest
    return [ServeRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                         task=port_cfg.name) for r in reqs]


def _record_groups(runtime, task: str, recs: Dict) -> None:
    """Mark each request of the window with the group whose engine runs
    it: each group's engine gets an instance ``run`` that notes the uids it
    is handed and calls the class's ``run`` (looked up at each call, so a
    span or a fault put on the class still applies)."""
    for name, eng in runtime.tasks[task].engines.items():
        def run(reqs, *args, _eng=eng, _name=name, **kwargs):
            for r in reqs:
                if r.uid in recs:
                    recs[r.uid].group = _name
            return type(_eng).run(_eng, reqs, *args, **kwargs)
        eng.run = run


def _log_batch(log, b: int, tel: Dict, wall: float) -> None:
    """One line a batch: its split, each group's wall and decode step."""
    for w in tel["waves"]:
        groups = ", ".join(
            f"{n} {g['n']} req {g['wall_s']:.3f} s "
            f"{1e3 * g['t_per_macro_step_s'] / tel['macro_steps']:.2f} ms/step "
            f"{g['admission_stalls']} stalls"
            for n, g in w["per_group"].items())
        log(f"batch {b}: {wall:.3f} s; {groups}")


def modules_found() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             traced: bool, *, t_start: Optional[float] = None,
             device: Optional[str] = None, look_for_chip: bool = True,
             mix_override: Optional[Dict] = None,
             config_override: Optional[Dict] = None,
             limits_override: Optional[Dict] = None,
             control: bool = False) -> Dict:
    """Run one cell once; returns the result line's object.  With
    ``control`` the fp8 control stands in the program's place in the check:
    the tokens that the reference computed in fp8 puts first are judged in
    place of the served ones, by the same limit (``served_logit_gap`` keeps
    the served tokens' gap)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    def log(*a):
        print(*a, file=sys.stderr, flush=True)
    root = Path(root)
    pb = root / "portbench"
    bench = load_bench(root)
    cell = cell_of(bench, cell_name)
    config = json.loads((pb / "configs" / f"{cell['config']}.json").read_text())
    config.update(config_override or {})
    mix = traffic_mod.load_mix(pb, cell["traffic"])
    mix.update(mix_override or {})
    limits = json.loads((pb / "limits" / f"{cell_name}.json").read_text())
    limits.update(limits_override or {})
    if look_for_chip:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            raise NoChip(f"{cell_name} needs {cell['chips']} CUDA device(s); "
                         f"found {torch.cuda.device_count()}")
        device = "cuda:0"
    dev = torch.device(device or "cpu")
    fam = family(pb, config["family"])
    sizes = common.sizes(config)
    run = Run(cell=cell, config=config, sizes=sizes, family=fam, mix=mix,
              seconds=float(seconds))

    # --- set-up: weights, runtime, one warm request through each group --
    port_cfg = port_config(config)
    params = fam.make_params(sizes, seed, dev)
    gen = traffic_mod.Generator(mix, sizes.vocab_size, seed)
    runtime = build_runtime(port_cfg, params, mix, dev)
    runtime.warmup(_serve_requests(port_cfg, [gen.warm()]))
    _record_groups(runtime, port_cfg.name, run.requests)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    restore, prof = (lambda: None), None
    if traced:
        spans = dict(HOST_SPANS, **span_targets(pb, bench, cell_name))
        _, restore = trace_mod.wrap(spans)
        prof = trace_mod.Recorder()
        prof.start()

    # --- the window ----------------------------------------------------
    recs = run.requests

    def on_tokens(uid, start, toks):
        now = time.perf_counter()
        r = recs[uid]
        if start != len(r.streamed):
            r.answers += 1000          # a replayed or skipped position
        r.streamed.extend(toks)
        r.landings.append((now, len(toks)))

    run.t0 = time.perf_counter()
    run.setup_s = run.t0 - t_start
    t_stop = run.t0 + run.seconds
    b = 0
    while time.perf_counter() < t_stop:
        batch = gen.batch(b)
        now = time.perf_counter()
        for r in batch:
            recs[r.uid] = RequestRecord(uid=r.uid, batch=b, due=now,
                                        prompt_len=len(r.prompt),
                                        max_new=r.max_new)
        res = runtime.serve(_serve_requests(port_cfg, batch), warm=False,
                            on_tokens=on_tokens)
        run.telemetry.append(res.telemetry)
        for outs in res.outputs.values():
            for o in outs:
                rec = recs.get(o.uid)
                if rec is None:
                    continue
                rec.answers += 1
                rec.tokens = np.asarray(o.tokens)
        _log_batch(log, b, res.telemetry, time.perf_counter() - now)
        if prof is not None:        # the trace holds the first batch
            t_pause = time.perf_counter()
            traced_s = t_pause - run.t0
            events = prof.stop()
            restore()
            prof = None
            run.paused_s = time.perf_counter() - t_pause
            t_stop += run.paused_s      # the pause is not serving time
        b += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.t_end = time.perf_counter()
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if traced:
        t_trace = time.perf_counter()
        run.trace = trace_mod.reduce(events, traced_s, spans=tuple(spans))
        run.traced_batches = {0}
        del events
        trace_s = time.perf_counter() - t_trace
    found_early = modules_found()

    # --- correct: every request answered once, in full ------------------
    unanswered = sum(1 for r in recs.values()
                     if r.answers != 1 or r.tokens is None
                     or len(r.tokens) != r.max_new)
    mismatched = sum(1 for r in recs.values() if r.tokens is not None
                     and list(map(int, r.tokens)) != r.streamed)

    # --- correct: the served tokens against the plain reference ---------
    del runtime
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    served_gap, n_tok, n_req, ctl_gap = reference_gap(run, params, seed,
                                                      dev, control)
    gap = ctl_gap if control else served_gap
    ref_s = time.perf_counter() - t_ref
    del params

    compared = {
        "unanswered": {"value": unanswered, "limit": 0},
        "stream_mismatch": {"value": mismatched, "limit": 0},
        "logit_gap": {"value": gap, "limit": limits["logit_gap"]},
    }
    correct = (unanswered == 0 and mismatched == 0
               and gap is not None and gap <= limits["logit_gap"])
    metrics = compute_metrics(pb, bench, run, traced)
    found = sorted(set(found_early) | set(modules_found()))
    if found:
        raise RuntimeError("modules of the JAX package loaded: "
                           + ", ".join(found))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": cell["chips"],
                   "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(recs),
              "failed": unanswered, "metrics": metrics,
              "device": device_info}
    if run.trace is not None:
        t = run.trace
        device_info["busy_s"] = t.busy_s
        device_info["window_s"] = t.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in t.device_ops],
            "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
        log(f"trace: busy {t.busy_s:.3f} of {t.window_s:.3f} s; device ops "
            f"by stream {t.ops_by_stream}; span calls {t.span_calls}, "
            f"device ranges {t.span_ranges}, device s {t.span_device_s}; "
            f"reduced in {trace_s:.1f} s")
    log(f"served {len(recs)} requests in {len(run.telemetry)} batches, "
        f"submissions for {run.seconds} s, window {run.window_s:.3f} s, "
        f"setup {run.setup_s:.3f} s; reference over {n_req} requests "
        f"({n_tok} tokens) in {ref_s:.3f} s")
    if control:
        result["served_logit_gap"] = served_gap
        log(f"control in the program's place; the served tokens' "
            f"logit_gap: {served_gap}")
    for k, v in compared.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    result["compared"] = compared
    return result


def reference_gap(run: Run, params, seed: int, dev, control: bool = False):
    """The widest gap by which a served token's logit lies below the
    plain reference's best, over a sample of the finished requests drawn
    from the seed: the longest of each group, then others in a seeded
    order until ``check.min_tokens`` tokens or ``check.max_requests``
    requests.  With ``control``, also the widest gap of the token that the
    reference computed in fp8 puts first at each of those positions.
    Returns (gap, tokens compared, requests compared, control's gap)."""
    import torch

    pick = sample(run, seed)
    if not pick:
        return None, 0, 0, None
    seqs, want, served = [], [], []
    gen = traffic_mod.Generator(run.mix, run.sizes.vocab_size, seed)
    prompts = {}
    for b in sorted({run.requests[u].batch for u in pick}):
        for r in gen.batch(b):
            prompts[r.uid] = r.prompt
    for uid in pick:
        toks = run.requests[uid].tokens.astype(np.int64)
        prompt = prompts[uid].astype(np.int64)
        seq = np.concatenate([prompt, toks[:-1]])
        seqs.append(torch.as_tensor(seq, device=dev))
        want.append(torch.arange(len(prompt) - 1, len(seq), device=dev))
        served.append(torch.as_tensor(toks, device=dev))
    logits = run.family.logits(params, run.sizes, seqs, want)

    def widest(tokens):
        return max(float((lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0])
                         .max()) for lg, t in zip(logits, tokens))

    ctl = None
    if control:
        ctl = widest([lg.argmax(-1) for lg in run.family.logits(
            params, run.sizes, seqs, want, control=True)])
    return widest(served), int(sum(len(t) for t in served)), len(pick), ctl


def sample(run: Run, seed: int) -> List[int]:
    chk = run.mix["check"]
    done = [r for r in run.requests.values()
            if r.answers == 1 and r.tokens is not None and len(r.tokens)]
    if not done:
        return []
    pick = []
    for g in sorted({r.group for r in done}):
        mine = [r for r in done if r.group == g]
        pick.append(max(mine, key=lambda r: (len(r.tokens), -r.uid)).uid)
    rng = np.random.default_rng([int(seed) % 2**63, 4])
    rest = [r.uid for r in done if r.uid not in pick]
    for i in rng.permutation(len(rest)):
        if len(pick) >= chk["max_requests"] or sum(
                len(run.requests[u].tokens) for u in pick) >= chk["min_tokens"]:
            break
        pick.append(rest[i])
    return pick
