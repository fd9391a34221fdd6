"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 50 --batch 8 --seq 64 [--reduced] [--microbatches 4] \
        [--remat] [--ckpt out.npz] [--device cuda|cpu]

Trains on the synthetic bigram corpus (``synthetic_lm_batches``, seed 0)
from random weights (seed 0) with AdamW (warmup ``max(steps // 10, 1)``,
cosine to ``total_steps = steps``), printing the loss, gradient norm and
learning rate ten times, then the tokens/s, and writes a checkpoint in the
JAX package's ``.npz`` layout with ``--ckpt``.  The flags are the JAX
launcher's plus ``--device``.  One device, no mesh (data and model axes are
not ported yet): the device is printed where the JAX launcher prints its
mesh.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import model as M
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train import make_train_step


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    print(f"device={device}  arch={cfg.name}"
          f"{' (reduced)' if args.reduced else ''}")

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
                              microbatches=args.microbatches)

    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(data))
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.2f}  "
                  f"lr={float(metrics['lr']):.2e}")
    synchronize(device)
    wall = time.perf_counter() - t0
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {toks/wall:.0f} tok/s wall")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt_state,
                        metadata={"arch": cfg.name, "steps": args.steps})
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
