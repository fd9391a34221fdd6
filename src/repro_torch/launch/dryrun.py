"""Multi-pod dry run of the port: every (architecture × input shape) on the
production mesh, traced on the meta device with NO allocation, from the
view of one rank (the JAX package's ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --out DIR

JAX lowers and compiles each program for 512 placeholder host devices and
reads XLA's cost and memory analyses.  The port runs its eager program
once on the meta device (tensors with shapes and dtypes and no data; the
meta device stands for the card, so the kernels' paths are taken) as rank
0 of the production mesh: ``make_production_mesh(view=True)`` needs no
process group, and its collectives are counted by kind and bytes and move
nothing.  ``serving/profiling.py:measure`` counts the program: flops and
bytes by operator, each hand-written kernel's flops and bytes by its
``kernels/costs.py`` formula (the same that gives its bound on the card),
the collectives, the argument and output bytes and the peak live bytes of
what the program makes (``temp_size_in_bytes``).  Compiled costs of two
compilers are not comparable, so these counts are the port's own, not
JAX's; and where JAX pins the XLA reference path at decode (its serve step
with ``use_pallas=False``), the port counts its kernels' own work.

The trace is ``trace_one``: ``train`` is ``make_train_step(layout=)``
with the params and the AdamW state cut by ``shard_params(fsdp=True)``;
``prefill`` is ``make_prefill_step``; ``decode`` is ``make_serve_step``
over the rank's block of the cache (``model.cache_shard``: long_500k's
batch of 1 spills onto the cache's sequence).  No environment variable is
set.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                     mesh_configs)
from repro_torch.configs.shapes import (INPUT_SHAPES, InputShape, applicable,
                                        get_shape)
from repro_torch.core.profiler import H100_HBM_BYTES
from repro_torch.launch.mesh import (make_production_mesh, shard_params,
                                     train_layout)
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.serving.profiling import measure
from repro_torch.training.checkpoint import named_leaves
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train import make_train_step

META = torch.device("meta")


# ---------------------------------------------------------------------------
def variant_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config adjustments: zamba2's weight-shared attention gets
    a 4096 sliding window for the 500k-decode shape (its full-attention
    block would otherwise carry an O(S) cache per shared-block invocation;
    the SSM backbone is the long-context path)."""
    if shape.name == "long_500k" and cfg.name == "zamba2-2.7b":
        return dataclasses.replace(cfg, sliding_window=4096)
    return cfg


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta stand-ins for every model input of the whole batch (no
    allocation): JAX's ``ShapeDtypeStruct`` tree."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.mode in ("train", "prefill"):
        text = S
        batch: Dict[str, Any] = {}
        if cfg.family in ("vlm", "audio"):
            if cfg.family == "vlm":
                text = S - cfg.frontend_tokens
            batch["frontend"] = torch.empty(
                (B, cfg.frontend_tokens, cfg.frontend_dim),
                dtype=cfg.torch_dtype, device=META)
        batch["tokens"] = torch.empty((B, text), dtype=tok, device=META)
        return batch
    # decode: ONE new token against a seq_len cache
    return {"token": torch.empty((B, 1), dtype=tok, device=META),
            "cache": M.init_cache(cfg, B, S, device=META),
            "cache_index": torch.empty((), dtype=torch.int32, device=META)}


def abstract_params(cfg: ModelConfig):
    return M.init_params(cfg, 0, device=META)


# ---------------------------------------------------------------------------
def trace_one(cfg: ModelConfig, shape: InputShape, mesh, *, fsdp: bool = True,
              remat: bool = True, microbatches: int = 1) -> Dict[str, Any]:
    """Run one (config × shape) program on the meta device as rank 0 of
    ``mesh`` and count it: :func:`measure`'s record plus ``mode`` and this
    rank's per-leaf parameter bytes (``param_bytes``)."""
    cfg = variant_config(cfg, shape)
    full = abstract_params(cfg)
    specs = input_specs(cfg, shape)

    if shape.mode == "train":
        layout = train_layout(full, mesh, fsdp=fsdp)
        params = shard_params(full, mesh, fsdp=fsdp)
        opt = init_opt_state(params)
        step = make_train_step(cfg, OptimizerConfig(), remat=remat,
                               microbatches=microbatches, layout=layout)
        rec = measure(lambda: step(params, opt, specs), mesh,
                      (params, opt, specs))
    else:
        params = shard_params(full, mesh)
        with sharding.activation_sharding(mesh), torch.no_grad():
            if shape.mode == "prefill":
                step = make_prefill_step(cfg)
                rec = measure(lambda: step(params, specs), mesh,
                              (params, specs))
            else:
                B, S = shape.global_batch, shape.seq_len
                cache = M.init_cache(cfg, B, S, device=META)  # rank's block
                shard = M.cache_shard(cfg, B, S)
                step = make_serve_step(cfg)
                args = (params, cache, specs["token"], specs["cache_index"])
                rec = measure(lambda: step(*args, shard), mesh, args)
    rec["mode"] = shape.mode
    rec["param_bytes"] = {k: t.numel() * t.element_size()
                          for k, t in named_leaves(params)}
    return rec


def layer_costs(cfg, shape, mesh) -> Dict[str, Any]:
    """Each block on its own (``roofline.block_cost``) and its trips: a
    breakdown of the program by block, never a correction of it (the
    program's counts already hold every trip)."""
    from repro_torch.launch.roofline import MODE_TRIPS, block_cost
    out = {"bodies": [{"kind": "layer",
                       "trips": MODE_TRIPS[shape.mode](cfg),
                       **block_cost(cfg, shape, mesh)}]}
    if cfg.family == "hybrid":
        shared = block_cost(cfg, shape, mesh, kind="dense")
        out["bodies"].append({"kind": "shared_attn",
                              "trips": cfg.num_layers // cfg.hybrid_attn_every,
                              **shared})
    if cfg.family == "audio" and shape.mode != "decode":
        enc_shape = dataclasses.replace(shape, seq_len=cfg.frontend_tokens)
        enc = block_cost(cfg, enc_shape, mesh, kind="dense")
        out["bodies"].append({"kind": "encoder", "trips": cfg.encoder_layers,
                              **enc})
    return out


def run_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
               fsdp: bool = True, remat: bool = True, microbatches: int = 1,
               verbose: bool = True, with_layer_costs: bool = False
               ) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if not applicable(cfg, shape):
        reason = "long_500k requires sub-quadratic attention"
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} skipped: {reason}",
                  flush=True)
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": True, "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod, view=True)
    t0 = time.perf_counter()
    rec = trace_one(cfg, shape, mesh, fsdp=fsdp, remat=remat,
                    microbatches=microbatches)
    t_trace = time.perf_counter() - t0
    res = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mesh": dict(mesh.shape), "rank": dict(zip(mesh.axes, mesh.coords)),
        "mode": rec.pop("mode"), "skipped": False, "fsdp": fsdp,
        "remat": remat, "trace_s": t_trace,
        "params": M.count_params_analytic(cfg),
        "active_params": M.count_params_analytic(cfg, active_only=True),
        **rec,
    }
    if with_layer_costs:
        try:
            res["layer_costs"] = layer_costs(variant_config(cfg, shape),
                                             shape, mesh)
        except Exception as e:  # noqa: BLE001 - recorded with its traceback
            res["layer_costs"] = {"error": f"{type(e).__name__}: {e}",
                                  "traceback": traceback.format_exc()}
    if verbose:
        gb = 1e9
        print(f"[dryrun] {arch} × {shape_name} mesh={tuple(mesh.shape.values())}"
              f" mode={res['mode']} OK  flops={res['flops']:.3e}"
              f" coll={res['collective_bytes']['total']:.3e}B"
              f" temp={res['temp_size_in_bytes'] / gb:.2f}GB"
              f" args={res['argument_size_in_bytes'] / gb:.2f}GB"
              f" fits_80GB={fits(res)} (trace {t_trace:.1f}s)", flush=True)
    return res


def fits(res: Dict[str, Any]) -> bool:
    """Whether the rank's arguments and peak temporaries fit one card."""
    return res["temp_size_in_bytes"] + res["argument_size_in_bytes"] \
        <= H100_HBM_BYTES


# ---------------------------------------------------------------------------
def combos(all_: bool, arch=None, shape=None, multi_pod: bool = False):
    if all_:
        return [(a, s, multi_pod) for a in mesh_configs()
                for s in sorted(INPUT_SHAPES)]
    if not (arch and shape):
        raise SystemExit("--arch/--shape or --all required")
    return [(arch, shape, multi_pod)]


def _one(combo, fsdp: bool, remat: bool, layer_costs: bool, out):
    """One combo of a sweep: its result, or its failure with the traceback
    (the sweep goes on); written to ``out`` as JSON when given."""
    arch, shape, mp = combo
    torch.set_num_threads(1)
    try:
        res = run_dryrun(arch, shape, multi_pod=mp, fsdp=fsdp, remat=remat,
                         with_layer_costs=layer_costs)
    except Exception as e:  # noqa: BLE001 - recorded, the sweep goes on
        res = {"arch": arch, "shape": shape, "multi_pod": mp,
               "skipped": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
        print(f"[dryrun] {arch} × {shape} FAILED: {res['error']}", flush=True)
    if out:
        os.makedirs(out, exist_ok=True)
        tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}.json"
        with open(os.path.join(out, tag), "w") as f:
            json.dump(res, f, indent=1)
    return res


def sweep(todo, *, fsdp: bool = True, remat: bool = True,
          layer_costs: bool = False, out=None, jobs: int = 1):
    """The results of every (arch, shape, multi_pod) of ``todo``, in order;
    ``jobs`` > 1 runs them in that many processes (the meta device needs no
    card, so the combos are independent)."""
    one = functools.partial(_one, fsdp=fsdp, remat=remat,
                            layer_costs=layer_costs, out=out)
    if jobs <= 1:
        return [one(c) for c in todo]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(jobs) as pool:
        return pool.map(one, todo, chunksize=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list_configs(), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) on the production mesh")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--layer-costs", action="store_true",
                    help="also count each block on its own (a breakdown)")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes to run the combos in")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    results = sweep(combos(args.all, args.arch, args.shape, args.multi_pod),
                    fsdp=not args.no_fsdp, remat=not args.no_remat,
                    layer_costs=args.layer_costs, out=args.out,
                    jobs=args.jobs)
    n_bad = sum(1 for r in results if r.get("error"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    print(f"[dryrun] done: {len(results)} combos, {n_skip} skipped, "
          f"{n_bad} failures in {time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
