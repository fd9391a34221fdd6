"""Training launcher (the JAX package's ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 50 --batch 8 --seq 64 [--reduced] [--microbatches 4] \
        [--remat] [--ckpt out.npz] [--device cuda|cpu]

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train [--mesh 2x2] [--dist-backend gloo] ...

Trains on the synthetic bigram corpus (``synthetic_lm_batches``, seed 0)
from random weights (seed 0) with AdamW (warmup ``max(steps // 10, 1)``,
cosine to ``total_steps = steps``), printing the loss, gradient norm and
learning rate ten times, then the tokens/s, and writes a checkpoint in the
JAX package's ``.npz`` layout with ``--ckpt``.  The flags are the JAX
launcher's plus ``--device`` and the mesh's.  Runs on the card unless
``--device cpu``.

One process trains on one device (the device is printed where the JAX
launcher prints its mesh).  Under ``torch.distributed.run`` every process
is a rank of a (data, model) mesh: ``--mesh DATAxMODEL``, or JAX's
``build_mesh`` rule ("model" the largest of 16/8/4/2/1 that divides the
world size, "data" the rest).  The params and AdamW state are cut by
``shard_params(fsdp=True)`` (FSDP over "data", the serving cuts over
"model"), each rank runs its batch rows, and rank 0 prints ``mesh={...}``
and the log; the checkpoint holds whole leaves.  ``--dist-backend``
defaults to NCCL on the card (one rank per card) and gloo on the CPU;
ranks that share one card need gloo, which stages every CUDA collective
through host memory.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.serve import parse_mesh
from repro_torch.models import model as M
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train import make_train_step


def build_mesh_shape(n: int):
    """JAX's ``build_mesh``: (data, model) with "model" the largest of
    16/8/4/2/1 that divides ``n``."""
    model = next(c for c in (16, 8, 4, 2, 1) if n % c == 0 and c <= n)
    return n // model, model


def _rank_device(device: torch.device) -> torch.device:
    """This rank's card: LOCAL_RANK's, modulo the cards there are."""
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Parse ``argv`` and train."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list_configs(), default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the same family")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL ranks (under torch.distributed.run; "
                         "default: JAX's build_mesh rule for the world size)")
    ap.add_argument("--dist-backend", default=None,
                    help="torch.distributed backend (default: nccl on "
                         "cuda, gloo on cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        _train_mesh(ap, args, cfg, _rank_device(device))
        return
    if args.mesh is not None:
        ap.error("--mesh runs under torch.distributed.run, one process per "
                 "rank (WORLD_SIZE is not set)")
    print(f"device={device}  arch={cfg.name}"
          f"{' (reduced)' if args.reduced else ''}")
    _train(args, cfg, device, layout=None, log=True)


def _train_mesh(ap, args, cfg, device) -> None:
    """This rank's part of the SPMD train step on a (data, model) mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (GROUP_TIMEOUT_S, Mesh, shard_params,
                                         train_layout)
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if args.mesh is None:
            data, model = build_mesh_shape(world)
        else:
            try:
                data, model = parse_mesh(args.mesh)
            except argparse.ArgumentTypeError as e:
                ap.error(str(e))
        if world != data * model:
            ap.error(f"--mesh {args.mesh} needs {data * model} ranks, "
                     f"torch.distributed.run started {world}")
        mesh = Mesh(np.arange(world).reshape(data, model), ("data", "model"))
        if rank == 0:
            print(f"mesh={dict(mesh.shape)}  arch={cfg.name}"
                  f"{' (reduced)' if args.reduced else ''}  backend={backend}"
                  f"  device={device}", flush=True)
        params = M.init_params(cfg, 0, device=device)
        layout = train_layout(params, mesh)
        params = shard_params(params, mesh, fsdp=True)
        _train(args, cfg, device, layout=layout, log=rank == 0, params=params)
    finally:
        dist.destroy_process_group()


def _train(args, cfg, device, *, layout, log: bool, params=None) -> None:
    if params is None:
        params = M.init_params(cfg, 0, device=device)
    opt_state = init_opt_state(params)
    data = synthetic_lm_batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
        frontend_dim=(cfg.frontend_dim or cfg.d_model) if cfg.frontend else 0))
    next(data)          # the JAX launcher draws one batch for its shardings

    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, remat=args.remat,
                              microbatches=args.microbatches, layout=layout)

    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(data))
        if log and (i % max(args.steps // 10, 1) == 0 or i == args.steps - 1):
            print(f"step {i:5d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.2f}  "
                  f"lr={float(metrics['lr']):.2e}", flush=True)
    synchronize(device)
    wall = time.perf_counter() - t0
    toks = args.steps * args.batch * args.seq
    if log:
        print(f"done: {args.steps} steps, {toks/wall:.0f} tok/s wall",
              flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt_state,
                        metadata={"arch": cfg.name, "steps": args.steps},
                        layout=layout)
        if log:
            print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
