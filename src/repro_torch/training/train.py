"""Training step and loop (the JAX package's ``repro/training/train.py``).

``make_train_step(cfg, opt_cfg)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``: next-token cross-entropy (+ the MoE router's
aux loss), gradients by ``torch.autograd`` (the MoE experts and the Mamba-1
recurrence through their differentiable kernels), then AdamW, which updates
the params and the optimizer state in place.  Batches may hold numpy arrays
(``synthetic_lm_batches``) or tensors; they are moved to the params' device.

On a (data, model) mesh (``make_train_step(layout=)``, a
``launch.mesh.TrainLayout``; the params and the AdamW state are this
rank's ``shard_params(fsdp=True)`` shards), the step is the JAX launcher's
GSPMD program written out, as its counterpart ``repro/launch/train.py``
places it: each rank takes its batch rows (``sharding.rank_shard``; all of
them when the batch does not divide the batch axes), splits them into its
microbatches, and differentiates its own loss term through the model's
collectives.  Its CE mean is its term of the global mean; the reported
``loss``, ``ce`` and ``aux`` are their mean over the batch axes.  A leaf's
gradient is then averaged over the batch axes: an FSDP-cut leaf's comes
out of its gather's reduce-scatter already summed and is divided by the
axes' size, any other is all_reduced and divided.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.core.offload import tree_leaves, tree_map
from repro_torch.device import upload
from repro_torch.distributed import collectives as coll
from repro_torch.kernels.ops import resolve_use_kernels
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.training.optimizer import (OptimizerConfig, OptState,
                                            adamw_update, init_opt_state)


def loss_fn(params, cfg, batch, *, remat: bool = True, shard=None,
            fsdp=None):
    """(loss, {"ce", "aux"}): next-token CE over the text positions plus the
    router aux loss, through the kernels on the card.  The vlm's logits
    cover [frontend | text]: the text tokens are predicted from the position
    before each, so its window starts at F-1 (the frontend's last row
    predicts the first text token).  On a mesh (``shard``, ``fsdp``: as
    ``model.forward`` takes them) ``batch`` holds this rank's rows and the
    loss is this rank's term; where "model" cuts the LM head the logits are
    the rank's vocabulary block and the CE is vocab-parallel."""
    tokens = batch["tokens"]
    out = M.forward(params, cfg, batch, mode="train", remat=remat,
                    use_kernels=resolve_use_kernels("auto", tokens.device),
                    shard=shard, fsdp=fsdp)
    if cfg.family == "vlm":
        F = cfg.frontend_tokens
        ce = M.cross_entropy(out.logits[:, F - 1:-1], tokens,
                             vocab=out.vocab)
    else:
        ce = M.cross_entropy(out.logits[:, :-1], tokens[:, 1:],
                             vocab=out.vocab)
    return ce + out.aux_loss, {"ce": ce, "aux": out.aux_loss}


def _to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) if torch.is_tensor(v) else upload(v, device)
            for k, v in batch.items()}


def value_and_grad(params, cfg, batch, *, remat: bool = True, **on_mesh):
    """(loss, parts, grads): ``grads`` mirrors ``params``, each leaf in its
    param's dtype (zeros for a leaf the loss does not reach, as JAX gives).
    ``on_mesh``: ``shard`` and ``fsdp`` as :func:`loss_fn` takes them (the
    gradients are then this rank's, before the mean over the batch axes)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, parts = loss_fn(leaves, cfg, batch, remat=remat, **on_mesh)
        flat = tree_leaves(leaves)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, gs)}
    grads = tree_map(lambda t: by_id[id(t)], leaves)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def _data_mean(grads, layout) -> None:
    """Average this rank's gradients over the batch axes, in place: an
    FSDP-cut leaf's were summed by its gather's reduce-scatter, any other
    leaf's are all_reduced here."""
    mesh = layout.mesh
    axes = batch_axes(mesh)
    n = mesh.axes_size(axes)

    def walk(g, pl):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], pl[k])
            return
        if pl.fsdp_dim is None:
            coll.all_reduce(g, mesh, axes)
        g.div_(n)

    if n > 1:
        walk(grads, layout.placements)


def make_train_step(cfg, opt_cfg: OptimizerConfig, *, remat: bool = True,
                    microbatches: int = 1, layout=None):
    """microbatches > 1: split the global batch and accumulate f32 gradients
    over the parts, then divide: the activation working set shrinks
    ×microbatches at the same math.  ``layout`` (a
    ``launch.mesh.TrainLayout``): the step of this rank of its mesh, on
    shards (module docstring); microbatches split the rank's rows."""
    def train_step(params, opt_state: OptState, batch):
        loss, parts, grads = step_grads(params, cfg, batch, remat=remat,
                                        microbatches=microbatches,
                                        layout=layout)
        params, opt_state, stats = adamw_update(opt_cfg, grads, opt_state,
                                                params, layout=layout)
        return params, opt_state, {"loss": loss, **parts, **stats}
    return train_step


def _accumulated(params, cfg, batch, remat: bool, microbatches: int,
                 **on_mesh):
    """(loss, parts, grads) of ``batch``, over ``microbatches`` parts."""
    if microbatches == 1:
        return value_and_grad(params, cfg, batch, remat=remat, **on_mesh)
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of "
                         f"microbatches={microbatches}")
    n = b // microbatches
    grads = lsum = asum = None
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        l, parts, g = value_and_grad(params, cfg, mb, remat=remat, **on_mesh)
        if grads is None:
            grads = tree_map(lambda t: t.float(), g)
            lsum, asum = l.float(), parts["aux"].float()
        else:
            tree_map(lambda acc, t: acc.add_(t.float()), grads, g)
            lsum, asum = lsum + l, asum + parts["aux"]
        del g
    tree_map(lambda acc: acc.div_(microbatches), grads)
    loss = lsum / microbatches
    return loss, {"ce": loss - asum / microbatches,
                  "aux": asum / microbatches}, grads


def step_grads(params, cfg, batch, *, remat: bool = True,
               microbatches: int = 1, layout=None):
    """(loss, {"ce", "aux"}, grads): what a train step hands AdamW.  On a
    mesh (``layout``) this rank's shards of the gradients of the global
    batch's loss, averaged over the batch axes, and the loss parts' mean
    over them (module docstring)."""
    batch = _to_device(batch, tree_leaves(params)[0].device)
    if layout is None:
        return _accumulated(params, cfg, batch, remat, microbatches)
    mesh = layout.mesh
    shard = sharding.rank_shard(mesh, batch["tokens"].shape[0])
    rows = slice(shard.b0, shard.b0 + shard.B_loc)
    batch = {k: v[rows] for k, v in batch.items()}
    with sharding.activation_sharding(mesh):
        loss, parts, grads = _accumulated(params, cfg, batch, remat,
                                          microbatches, shard=shard,
                                          fsdp=layout.fsdp_dims())
    _data_mean(grads, layout)
    means = coll.mean(torch.stack([loss.float(), parts["ce"].float(),
                                   parts["aux"].float()]),
                      mesh, batch_axes(mesh))
    return means[0], {"ce": means[1], "aux": means[2]}, grads


@dataclass
class TrainReport:
    steps: int
    final_loss: float
    first_loss: float
    wall_s: float
    losses: list


def train_loop(cfg, params, data_iter: Iterator[Dict[str, Any]],
               opt_cfg: Optional[OptimizerConfig] = None, *, steps: int = 100,
               log_every: int = 10, remat: bool = False,
               callback: Optional[Callable] = None) -> tuple:
    """Single-device training loop used by the examples and tests; returns
    (params, opt_state, TrainReport).  The loss is read to the host at the
    logged steps only."""
    opt_cfg = opt_cfg or OptimizerConfig(total_steps=steps)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, remat=remat)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(data_iter))
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(metrics["loss"]))
            if callback:
                callback(i, metrics)
    wall = time.perf_counter() - t0
    report = TrainReport(steps=steps, final_loss=losses[-1],
                         first_loss=losses[0], wall_s=wall, losses=losses)
    return params, opt_state, report
