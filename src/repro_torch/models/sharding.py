"""The active mesh and the layouts the model reads on it (the JAX
package's ``repro/models/sharding.py``).

``activation_sharding(mesh)`` makes ``mesh`` the one the model code runs
on; outside it (one process) the model runs unsharded.  The JAX package
needs ``constrain`` hints because GSPMD propagates placements; under
explicit collectives every rank computes on exactly the block it holds
(:class:`RankShard`), so ``constrain`` and ``shard_map_compat`` have no
counterpart here and are not copied.

In training the params are also FSDP-cut over the batch axes
(``launch.mesh.shard_params(fsdp=True)``): :func:`gather_fsdp` makes a
layer's (or a top-level leaf's) whole copy right before it runs.

``seq_shard_layout`` is the JAX function verbatim: how a [B, S, Hkv, dh]
KV cache lays out on the mesh.  ``replicate`` is ``put_replicated``: it
broadcasts the engine's carried decode-state vectors from the mesh's first
rank, so every rank starts a dispatch from the same state.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.offload import mesh_axis_sizes, tree_map
from repro_torch.distributed import collectives as coll
from repro_torch.launch.mesh import (Mesh, ModelCuts, batch_axes, model_cuts,
                                     world_ranks)

_STATE = {"mesh": None}


@contextmanager
def activation_sharding(mesh):
    """Run the model code inside the block on ``mesh``."""
    old = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = old


def active_mesh():
    return _STATE["mesh"]


def scaleout_mesh(ranks: Optional[Sequence[int]] = None,
                  axes: Tuple[str, ...] = ("data", "model")) -> Mesh:
    """Balanced ("data","model") mesh over every rank of the process group
    (or ``ranks``): the same factorization the OffloadEngine uses for node
    group sub-meshes, so 8 ranks give (4, 2), 64 give (8, 8)."""
    ranks = list(world_ranks() if ranks is None else ranks)
    if len(axes) == 1:
        return Mesh(np.array(ranks), axes)
    shape = mesh_axis_sizes(len(ranks), len(axes))
    return Mesh(np.array(ranks).reshape(shape), axes)


def replicate(tree, mesh=None):
    """Broadcast every tensor leaf of ``tree`` in place from the first rank
    of ``mesh`` (default: the active mesh) to all of its ranks; returns
    ``tree``.  The identity off-mesh."""
    mesh = mesh if mesh is not None else _STATE["mesh"]
    if mesh is None:
        return tree
    tree_map(lambda t: coll.broadcast(t, mesh) if torch.is_tensor(t) else t,
             tree)
    return tree


class SeqShardLayout(NamedTuple):
    """How a [B, S, Hkv, dh] KV-cache leaf lays out on a model-sharded mesh.

    ``bspec``/``sspec``/``hspec`` are the PartitionSpec entries for the
    batch, sequence and kv-head dims; ``s_axes`` are the mesh axes the
    sequence dim shards over and ``s_local`` is the per-shard sequence
    length.  Shared by the scalar and per-slot ``cache_update`` paths and
    ``splice_blocks`` so they agree byte-for-byte on the cache layout."""
    bspec: object
    sspec: object
    hspec: Optional[str]
    s_axes: Tuple[str, ...]
    s_local: int


def seq_shard_layout(mesh, B: int, S: int, Hkv: int) -> Optional[SeqShardLayout]:
    """Resolve the KV-cache layout for ``mesh``, or None when the sequence
    dim ends up unsharded (a dynamic-index update is already shard-local).

    Batch axes ("pod"/"data") shard the batch dim when it divides; otherwise
    they spill onto the sequence dim.  The kv-head dim takes "model" when it
    divides, else "model" also shards the sequence."""
    msize = mesh.shape["model"]
    baxes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    bdiv = int(np.prod([mesh.shape[a] for a in baxes])) if baxes else 1
    b_sharded = bool(baxes) and B % bdiv == 0 and B >= bdiv
    s_axes = [] if b_sharded else list(baxes)
    if Hkv % msize != 0 or Hkv < msize:
        s_axes.append("model")
    sdiv = int(np.prod([mesh.shape[a] for a in s_axes])) if s_axes else 1
    if not s_axes or S % sdiv != 0 or S < sdiv:
        return None
    bspec = (baxes if len(baxes) > 1 else baxes[0]) if b_sharded else None
    sspec = tuple(s_axes) if len(s_axes) > 1 else s_axes[0]
    hspec = "model" if (Hkv % msize == 0 and Hkv >= msize) else None
    return SeqShardLayout(bspec, sspec, hspec, tuple(s_axes), S // sdiv)


class RankShard(NamedTuple):
    """The block of a batch-``B`` forward (and of its decode cache) this
    rank holds on ``mesh``: batch rows [b0, b0 + B_loc) -- all of them when
    the batch does not divide the batch axes -- and cache rows [s0, s0 +
    S_loc) of the sequence (``seq`` None: all of them).  The sequence is a
    K/V leaf's: a state leaf (a Mamba conv or SSM state) and the audio
    decoder's cross K/V have none, and hold the rank's batch rows whole
    (:meth:`held_rows`)."""
    mesh: object
    B: int
    b_sharded: bool
    b0: int
    B_loc: int
    seq: Optional[SeqShardLayout]
    s0: int
    S_loc: int

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return batch_axes(self.mesh) if self.b_sharded else ()

    def cuts(self, cfg) -> ModelCuts:
        """How ``cfg``'s params are cut over this mesh's "model" axis
        (``launch.mesh.model_cuts``: made once per config and axis size
        from the placements ``shard_params`` gives): the attention case,
        the tables' and ``frontend_proj``'s cuts the layers run."""
        return model_cuts(cfg, self.mesh.shape.get("model", 1))

    def held_rows(self, n_src: int, kv: bool = True) -> slice:
        """The rows of an ``n_src``-row source block (axis 2 of a prefill
        cache leaf) that this rank's block holds, from its row 0: a K/V
        leaf's sequence shard, clipped to the source; every row of a state
        or cross leaf (``kv=False``)."""
        if not kv or self.seq is None:
            return slice(0, n_src)
        return slice(self.s0, max(self.s0, min(n_src, self.s0 + self.S_loc)))


def rank_shard(mesh, B: int, *, Hkv: int = 0,
               S: Optional[int] = None) -> RankShard:
    """This rank's :class:`RankShard` of a batch-``B`` forward on ``mesh``;
    give the cache's length ``S`` (and its kv heads ``Hkv``) to resolve the
    cache layout too.  The one place the batch and sequence placement is
    decided: the cache is allocated by it (``model.init_cache``) and every
    decode, slot write and splice takes the same block (``model.cache_shard``)."""
    baxes = batch_axes(mesh)
    bdiv = mesh.axes_size(baxes)
    b_sharded = bool(baxes) and B % bdiv == 0 and B >= bdiv
    B_loc = B // bdiv if b_sharded else B
    b0 = mesh.linear_index(baxes) * B_loc if b_sharded else 0
    seq = None
    if S is not None and "model" in mesh.shape:
        seq = seq_shard_layout(mesh, B, S, Hkv)
    if seq is None:
        return RankShard(mesh, B, b_sharded, b0, B_loc, None, 0, S or 0)
    s0 = mesh.linear_index(seq.s_axes) * seq.s_local
    return RankShard(mesh, B, b_sharded, b0, B_loc, seq, s0, seq.s_local)


def gather_fsdp(tree, dims, mesh, *, layer: bool = False):
    """The whole leaves of a tree of this rank's FSDP slices: each leaf
    whose dim in ``dims`` (a tree of ints or None, mirroring ``tree``;
    ``launch.mesh.TrainLayout.fsdp_dims``) is not None is gathered over
    the batch axes (``collectives.fsdp_gather``: its gradient is
    reduce-scattered).  ``layer``: ``tree`` is one layer of an L-stacked
    tree, whose leaves lost the layer axis the dims count.  ``dims`` None
    returns ``tree``."""
    if dims is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_fsdp(v, dims[k], mesh, layer=layer)
                for k, v in tree.items()}
    if layer and dims == 0:
        raise ValueError("a leaf FSDP-cut on its layer axis cannot be "
                         "gathered a layer at a time")
    return coll.fsdp_gather(tree, mesh, batch_axes(mesh),
                            dims - 1 if layer else dims)
