"""AdamW with a linear-warmup cosine schedule, on dicts of tensors (the JAX
package's ``repro/training/optimizer.py``; no ``torch.optim``).

The state mirrors the params: f32 ``m`` and ``v`` of each leaf's shape and
a scalar int32 step, all on the params' device.  ``adamw_update`` updates
params, ``m`` and ``v`` in place under ``no_grad`` (where JAX returns new
trees) and computes in f32, casting each param back to its dtype.  Weight
decay follows JAX's rule exactly: a leaf with ``ndim >= 2`` decays, and the
stacked layer axis counts, so the L-stacked norm scales ``[L,d]`` and the
SSM's ``D`` / ``dt_bias`` ``[L,di]`` decay while ``final_norm`` ``[d]`` does
not.

On a mesh (``layout``, a ``launch.mesh.TrainLayout``) every tree holds
this rank's shards: ``m`` and ``v`` take the params' shapes, the step is
replicated, the update is leaf-local, and slicing keeps a leaf's ndim, so
the decay rule still keys on the whole leaf's.  Only the clipping norm
crosses ranks: :func:`global_norm` counts every element once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.core.offload import tree_leaves, tree_map
from repro_torch.distributed import collectives as coll


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    m: Any
    v: Any


def lr_at(cfg: OptimizerConfig, step, device=None) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as an f32 scalar
    tensor: linear warmup to ``lr``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> OptState:
    device = tree_leaves(params)[0].device
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=zeros, v=tree_map(torch.clone, zeros))


def _replicas(layout):
    """Each leaf's replica count, in ``tree_leaves`` order."""
    def walk(tree):
        if isinstance(tree, dict):
            return [r for v in tree.values() for r in walk(v)]
        return [tree.replicas]
    return walk(layout.placements)


def global_norm(tree, layout=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` together.  On a mesh
    (``layout``) ``tree`` holds this rank's shards: each leaf's sum of
    squares is divided by the ranks that hold the same elements, and one
    all_reduce over the whole mesh adds them (every element once)."""
    if layout is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    sq = sum(torch.sum(torch.square(x.float())) / r
             for x, r in zip(tree_leaves(tree), _replicas(layout)))
    mesh = layout.mesh
    return torch.sqrt(coll.all_reduce(sq.reshape(1), mesh, mesh.axes)[0])


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state: OptState, params, *,
                 layout=None):
    """Returns (params, state, stats) with ``params``, ``state.m`` and
    ``state.v`` updated in place, a new step count, and stats
    {"grad_norm", "lr"} (scalar tensors).  Gradients are clipped to global
    norm ``grad_clip``; ``layout``: the trees are this rank's shards."""
    step = state.step + 1
    gn = global_norm(grads, layout)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(state.m), tree_leaves(state.v))
    for p, g, m, v in leaves:
        g = g.float() * clip
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (the stacked axis counts)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, OptState(step, state.m, state.v), {"grad_norm": gn, "lr": lr}
