"""End-to-end training driver on the PyTorch port: train a ~100M-param
llama-family model for a few hundred steps on the synthetic bigram corpus.

    PYTHONPATH=src python examples/train_small_torch.py [--steps 300] [--tiny] \
        [--device cuda|cpu]

The twin of ``examples/train_small.py``: config system -> data pipeline ->
AdamW -> checkpointing -> loss curve.  ``--tiny --device cpu`` uses the
reduced config and finishes in well under a minute on a CPU; the ~100M
variant is meant for the card (the default device).
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.offload import tree_leaves
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.models import model as M
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train import train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-friendly demo)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "heteroedge_train_torch.npz"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    base = get_config(args.arch)
    if args.tiny:
        cfg = reduced(base)
        batch, seq = 8, 64
    else:
        # ~100M-param member of the same family
        cfg = dataclasses.replace(
            base, num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32768, dtype="float32")
        batch, seq = 8, 256

    params = M.init_params(cfg, 0, device=args.device)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"training {cfg.name} variant: {n / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {batch} × seq {seq} on {args.device}")

    data = synthetic_lm_batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch))
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=20,
                              total_steps=args.steps)

    def log(i, metrics):
        print(f"  step {i:4d}  loss={float(metrics['loss']):.4f}  "
              f"lr={float(metrics['lr']):.2e}  "
              f"gnorm={float(metrics['grad_norm']):.2f}")

    params, opt_state, rep = train_loop(
        cfg, params, data, opt_cfg, steps=args.steps, log_every=20,
        callback=log)
    print(f"loss: {rep.first_loss:.3f} -> {rep.final_loss:.3f} "
          f"({rep.wall_s:.0f}s wall)")
    assert rep.final_loss < rep.first_loss

    save_checkpoint(args.ckpt, params, opt_state,
                    metadata={"steps": args.steps, "arch": cfg.name})
    _, _, meta = restore_checkpoint(args.ckpt, params, opt_state)
    print(f"checkpoint saved+verified at {args.ckpt}  (meta={meta})")


if __name__ == "__main__":
    main()
