"""The rank mesh, and the placement rules of the JAX package's
``repro/launch/mesh.py``.

A :class:`Mesh` is the port's ``jax.sharding.Mesh``: a grid of
``torch.distributed`` ranks with named axes ("pod", "data", "model"),
``shape`` as a dict, and one process group per axis line (the ranks that
share every other coordinate), made for every set of axes.  The port is
SPMD: every rank runs the same host code on its own shard and launches its
own kernels; ranks meet only in the collectives of
``distributed/collectives.py``.

``param_spec`` is the JAX rule verbatim: for every leaf it gives the
placement JAX's ``params_shardings`` gives (a tuple standing for the
``PartitionSpec``).  ``shard_params`` is the serving counterpart of
``params_shardings``: it slices each leaf to this rank's part on the
"model" axis and, for training (``fsdp=True``), one more dim over the
batch axes: FSDP's second split (:class:`TrainLayout`; ``gather_params``
is its inverse).  The attention projections, the vocab tables and
``frontend_proj`` are cut on ``param_spec``'s own dim, its fallback
included: where the axis does not divide the preferred dim (a head count)
the leaf goes on the largest other dim it divides, and the layer code runs
that cut with explicit collectives (:class:`ModelCuts`: Case Q puts
``wk``/``wv`` on their D rows, Case D every projection on D, a table on D
where the vocabulary does not divide).  So is the MoE router (on its
experts, or D), which each MoE layer gathers whole.  A Mamba mixer's
leaves are cut on their channels (Mamba-2's per-head leaves and its
``dt_proj`` on their heads), the dims of JAX's spec.  The MoE layer's
shared experts keep a cut of their own: their hidden width, where JAX's
spec (which takes them for the hybrid's unstacked shared block) cuts
their layer axis; the same bytes a rank.  ``data_specs`` /
``shard_batch`` are the counterpart of ``data_shardings``.

Sharding strategy (the JAX package's DESIGN.md §5):
  * "model" axis: tensor/expert parallel -- attention heads, MLP hidden,
    MoE experts, vocab, SSM inner channels.
  * "data" axis: batch (and, in training, FSDP-style parameter sharding).
  * "pod" axis (multi-pod): pure data parallel.
"""
from __future__ import annotations

import datetime
import functools
import itertools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.distributed import collectives as coll


GROUP_TIMEOUT_S = 120     # a collective that waits longer fails


class Mesh:
    """A grid of ranks with named axes.

    ``ranks`` holds global ``torch.distributed`` ranks in the grid's shape.
    With a process group initialised, constructing a mesh is itself a
    collective: every rank of the world must construct the same meshes in
    the same order (``new_group``'s rule), members or not.  Without one,
    or with ``groups=False``, the mesh has no process groups: it then
    stands for one process (the collectives are identities) or only states
    a shape (the rules).

    With ``view=True`` the mesh stands for one rank of the grid, the
    first of ``ranks`` (rank 0 of the production mesh in the dry run), in
    one process: it makes no process group, and every collective is
    counted by kind and bytes as that rank would issue it and moves
    nothing (``collectives.VIEW``)."""

    def __init__(self, ranks, axes: Sequence[str], *,
                 timeout_s: float = GROUP_TIMEOUT_S, groups: bool = True,
                 view: bool = False):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axes = tuple(axes)
        if self.ranks.ndim != len(self.axes):
            raise ValueError(f"ranks of shape {self.ranks.shape} for axes "
                             f"{self.axes}")
        self.shape: Dict[str, int] = dict(zip(self.axes, self.ranks.shape))
        self.counters: list = []          # active CollectiveCounters
        self.view = bool(view)
        self.rank = dist.get_rank() if dist.is_initialized() and not view \
            else int(self.ranks.flat[0])
        where = np.argwhere(self.ranks == self.rank)
        self.coords: Optional[Tuple[int, ...]] = \
            tuple(int(c) for c in where[0]) if len(where) else None
        self._groups: Dict[Tuple[str, ...], Any] = {}
        if groups and dist.is_initialized() and not view:
            timeout = datetime.timedelta(seconds=timeout_s)
            for n in range(1, len(self.axes) + 1):
                for sub in itertools.combinations(self.axes, n):
                    for line in self._lines(sub):
                        group = dist.new_group(line, timeout=timeout)
                        if self.rank in line:
                            self._groups[sub] = group

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def _lines(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every line along ``axes``: the ranks that share the other
        coordinates, first-axis-major."""
        idx = [self.axes.index(a) for a in axes]
        rest = [i for i in range(len(self.axes)) if i not in idx]
        grid = np.transpose(self.ranks, rest + idx).reshape(
            -1, int(np.prod([self.ranks.shape[i] for i in idx])))
        return [[int(r) for r in row] for row in grid]

    def canon(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` in the mesh's own order."""
        return tuple(a for a in self.axes if a in tuple(axes))

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name``."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        return self.coords[self.axes.index(name)]

    def axes_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def linear_index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` taken together, the first axis
        major (a shard's index under a PartitionSpec entry of those axes)."""
        lin = 0
        for a in axes:
            lin = lin * self.shape[a] + self.axis_index(a)
        return lin

    def line_ranks(self, axes: Sequence[str]) -> List[int]:
        """The ranks of this rank's line along ``axes``."""
        axes = self.canon(axes)
        return next(line for line in self._lines(axes) if self.rank in line)

    def group(self, axes: Sequence[str]):
        """The process group of this rank's line along ``axes`` (None for
        no axes, or a mesh without process groups; ``collectives.VIEW`` on
        a rank view)."""
        axes = self.canon(axes)
        if not axes:
            return None
        return coll.VIEW if self.view else self._groups.get(axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def world_ranks() -> List[int]:
    """Every rank of the initialised process group (``[0]`` without one)."""
    return list(range(dist.get_world_size())) if dist.is_initialized() \
        else [0]


def make_production_mesh(*, multi_pod: bool = False,
                         view: bool = False) -> Mesh:
    """The production mesh: (data, model) = (16, 16), or (pod, data, model)
    = (2, 16, 16) with ``multi_pod``, over the first 256 or 512 ranks of
    the process group.  ``view``: rank 0's view of it in this process
    (:class:`Mesh`'s ``view``), which needs no process group -- the dry
    run's counterpart of JAX's 512 placeholder host devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if view:
        return Mesh(np.arange(n).reshape(shape), axes, view=True)
    ranks = world_ranks()
    if len(ranks) < n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh, have {len(ranks)} -- "
            "launch one process per card with torch.distributed.run over "
            f"{n} cards")
    return Mesh(np.array(ranks[:n]).reshape(shape), axes)


def make_smoke_mesh() -> Mesh:
    """1x1 mesh of this rank with the same axis names: it makes no process
    group, so its collectives are identities."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(np.full((1, 1), rank), ("data", "model"), groups=False)


# ---------------------------------------------------------------------------
# Parameter sharding rules (the JAX package's, verbatim)
# ---------------------------------------------------------------------------
# leaf-name -> preferred model-parallel dim (negative = from the end),
# counted on the UNSTACKED tensor (scan adds a leading L dim handled below).
_MODEL_DIM_BY_NAME = {
    "table": 0,        # [V, D]   vocab-parallel embedding / lm head
    "wq": 1,           # [D, H, dh]
    "wk": 1,           # [D, Hkv, dh]
    "wv": 1,
    "wo": 0,           # [H, dh, D]
    "w_gate": -1,      # [D, F] or [E, D, F]
    "w_up": -1,
    "w_down": -2,      # [F, D] or [E, F, D]
    "router": 1,       # [D, E]
    "in_proj": 1,      # [D, 2di]
    "bc_proj": 0,      # [di, 2N]
    "x_proj": 0,       # [di, r+2N]
    "dt_proj": 1,      # [r, di] / [di, H]
    "out_proj": 0,     # [di, D]
    "conv_w": 1,       # [W, di]
    "conv_b": 0,
    "A_log": 0,        # [di, N] / [H]
    "D": 0,            # [di] / [H]
    "dt_bias": 0,
    "frontend_proj": 1,
}
# MoE expert tensors: expert dim is the model-parallel dim instead
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _path_names(path) -> Tuple[str, ...]:
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _preferred_dim(names: Tuple[str, ...], nd: int, stacked: bool):
    offset = 1 if (stacked and nd >= 2) else 0  # leading scan/L dim
    leaf = names[-1]
    if "moe" in names and leaf in _EXPERT_LEAVES:
        return offset  # expert dim
    if leaf in _MODEL_DIM_BY_NAME:
        d = _MODEL_DIM_BY_NAME[leaf]
        return d + nd if d < 0 else d + offset
    return None


def param_spec(path, shape: Tuple[int, ...], *, model_size: int,
               data_size: int, stacked: bool, fsdp: bool = True,
               fsdp_axes: Optional[Tuple[Tuple[str, ...], int]] = None
               ) -> tuple:
    """The PartitionSpec of one parameter tensor, as a tuple (one entry per
    dim: None, an axis name or a tuple of names)."""
    names = _path_names(path)
    nd = len(shape)
    spec: list = [None] * nd
    offset = 1 if (stacked and nd >= 2) else 0  # leading scan/L dim
    preferred = _preferred_dim(names, nd, stacked)

    def ok_model(i):
        return 0 <= i < nd and shape[i] % model_size == 0 and shape[i] >= model_size

    model_dim = None
    if preferred is not None:
        if ok_model(preferred):
            model_dim = preferred
        else:
            # fallback: largest other dim divisible by the model axis
            # (e.g. internvl2's 14 heads can't take a 16-way axis -- its
            # d_model=896 can)
            for i in sorted(range(offset, nd), key=lambda j: -shape[j]):
                if ok_model(i):
                    model_dim = i
                    break
    if model_dim is not None:
        spec[model_dim] = "model"

    if fsdp:
        # FSDP: shard one more large dim over the batch axes -- ("pod","data")
        # on the multi-pod mesh, "data" alone on a single pod.
        axes, size = fsdp_axes if fsdp_axes else (("data",), data_size)
        cands = sorted(range(offset, nd), key=lambda i: -shape[i])
        for i in cands:
            if i != model_dim and spec[i] is None \
                    and shape[i] % size == 0 and shape[i] >= 4 * size:
                spec[i] = axes if len(axes) > 1 else axes[0]
                break
    return tuple(spec)


def _stacked(names: Tuple[str, ...]) -> bool:
    stacked = "blocks" in names or "encoder" in names or "backbone" in names
    # the hybrid "shared" block is NOT stacked
    if "shared" in names and "backbone" not in names:
        stacked = False
    return stacked


def _walk(tree, fn, names=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_walk(v, fn, names + (str(i),)) for i, v in enumerate(tree))
    return fn(names, tree)


def params_specs(params, mesh: Mesh, *, fsdp: bool = True):
    """The spec tree ``params_shardings`` places a param tree by."""
    model_size = mesh.shape.get("model", 1)
    data_size = mesh.shape.get("data", 1)
    fsdp_ax = tuple(a for a in ("pod", "data") if a in mesh.shape)
    fsdp_axes = (fsdp_ax, int(np.prod([mesh.shape[a] for a in fsdp_ax]))) \
        if fsdp_ax else None
    return _walk(params, lambda names, leaf: param_spec(
        names, tuple(leaf.shape), model_size=model_size, data_size=data_size,
        stacked=_stacked(names), fsdp=fsdp, fsdp_axes=fsdp_axes))


def _slice(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Shard ``i`` of ``n`` along ``dim``, as a contiguous tensor of its own
    (so the full leaf can be freed)."""
    step = t.shape[dim] // n
    return t.narrow(dim, i * step, step).contiguous()


def mamba_splits(d_inner: int, heads: int, model_size: int) -> bool:
    """Whether a Mamba mixer of ``d_inner`` channels splits over a "model"
    axis of ``model_size``: each rank takes d_inner / m channels, which
    for Mamba-2 (``heads`` > 0: its channels reshape to heads of
    d_inner / heads) must be whole heads.  Otherwise every rank holds the
    whole mixer and runs it replicated."""
    def divides(n):
        return n % model_size == 0 and n >= model_size
    return model_size > 1 and divides(d_inner) and (not heads or divides(heads))


# A split Mamba mixer: each leaf's channel (d_inner) dim, or for Mamba-2's
# per-head leaves its head dim, counted from the end; ``in_proj`` [.., D,
# 2 di] is the u and z halves side by side, so a rank takes its channels
# of each half (:func:`_slice_halves`).  Mamba-1's ``x_proj`` and both
# versions' ``out_proj`` (and Mamba-2's ``bc_proj``) are split on their di
# rows: their products are partial sums the mixer all_reduces.  Mamba-2's
# ``dt_proj`` [.., di, H] is stored on its heads, as JAX's spec places it;
# the mixer gathers it and computes with its di rows
# (``models/ssm.py``).
_MAMBA_DIM = {
    1: {"conv_w": -1, "conv_b": -1, "x_proj": -2, "dt_proj": -1,
        "dt_bias": -1, "A_log": -2, "D": -1, "out_proj": -2},
    2: {"conv_w": -1, "conv_b": -1, "bc_proj": -2, "dt_proj": -1,
        "dt_bias": -1, "A_log": -1, "D": -1, "out_proj": -2},
}


def _slice_halves(t: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Shard ``i`` of ``n`` of each half of ``t``'s last dim, side by side
    (``in_proj``'s u and z channels of this rank)."""
    u, z = t.chunk(2, dim=-1)
    return torch.cat([_slice(u, -1, n, i), _slice(z, -1, n, i)], dim=-1)


# leaves cut on ``param_spec``'s dim, its fallback included
_SPEC_LEAVES = ("wq", "wk", "wv", "wo", "table", "frontend_proj", "router")


def serving_model_dim(names: Tuple[str, ...], shape: Tuple[int, ...],
                      model_size: int):
    """The dim a serving rank slices a leaf on ("model" axis), or None.
    The attention projections, the vocab tables, ``frontend_proj`` and the
    MoE router: ``param_spec``'s model dim, the fallback included
    (:data:`ATTN_CUTS` and :data:`TABLE_CUTS` name the cuts the layer code
    runs; the MoE layer gathers the router whole, as the JAX shard_map
    takes it); the MoE layer's shared experts on their hidden width, as a
    dense MLP; any other leaf on its preferred dim when the axis divides
    it.  A Mamba mixer's leaves are :func:`shard_params`'
    (``_MAMBA_DIM``)."""
    leaf = names[-1]
    if model_size == 1:
        return None
    stacked = _stacked(names)
    if leaf in _SPEC_LEAVES:
        spec = param_spec(names, shape, model_size=model_size, data_size=1,
                          stacked=stacked, fsdp=False)
        return next((i for i, e in enumerate(spec) if e == "model"), None)
    if "moe" in names and "shared" in names:
        # the shared experts are one dense MLP, split on its hidden width
        names = tuple(n for n in names if n != "moe")
    dim = _preferred_dim(names, len(shape), stacked)
    if dim is None or not (shape[dim] % model_size == 0
                           and shape[dim] >= model_size):
        return None
    return dim


class Placement(NamedTuple):
    """Where one leaf of a param tree lives on a mesh: the whole leaf's
    ``shape``; ``model_dim``, the dim the port cuts over "model" (None:
    every rank of a model line holds it whole), ``halves`` when that cut
    takes each half of the dim (``in_proj``'s u and z channels);
    ``fsdp_dim``, the dim training cuts over the batch axes (None: not
    cut); and ``replicas``, the ranks that hold each of its elements."""
    shape: Tuple[int, ...]
    model_dim: Optional[int]
    halves: bool
    fsdp_dim: Optional[int]
    replicas: int


# The cuts of an attention sublayer the layer code runs
# (``models/attention.py``), by case: each projection's "model" dim counted
# from the end (wq/wk/wv [.., D, H, dh], wo [.., H, dh, D]).  "heads": the
# axis divides the kv heads; "q": it divides the query heads only, so
# wk/wv go on their D rows; "d": it divides neither, so every projection
# goes on D (wo on its output columns).
ATTN_CUTS = {
    "heads": {"wq": -2, "wk": -2, "wv": -2, "wo": -3},
    "q": {"wq": -2, "wk": -3, "wv": -3, "wo": -3},
    "d": {"wq": -3, "wk": -3, "wv": -3, "wo": -1},
}
# a vocab table [V, D] on its rows or on its D columns; frontend_proj
# [F_in, D] on its D columns
TABLE_CUTS = {-2: "vocab", -1: "d"}
FRONTEND_CUTS = {-1: "d"}


class ModelCuts(NamedTuple):
    """How a model's sublayers are cut over "model", as the layer code
    reads them: ``attn`` a key of :data:`ATTN_CUTS` (every attention
    sublayer of the model, self and cross, encoder and decoder, takes the
    same), ``embed`` / ``head`` (the input table, the LM head's: the tied
    table's when tied) and ``frontend`` a value of :data:`TABLE_CUTS` /
    :data:`FRONTEND_CUTS`; None: whole on every rank."""
    attn: Optional[str]
    embed: Optional[str]
    head: Optional[str]
    frontend: Optional[str]


WHOLE = ModelCuts(None, None, None, None)


def _from_end(dim: Optional[int], nd: int) -> Optional[int]:
    return None if dim is None else dim - nd


def _attn_case(tree, cut, names) -> Optional[str]:
    """The :data:`ATTN_CUTS` case of an attention sublayer's cuts (None:
    whole); NotImplementedError for a cut the layer code does not run."""
    dims = {k: _from_end(cut[k][0], tree[k].dim())
            for k in ("wq", "wk", "wv", "wo")}
    if all(d is None for d in dims.values()):
        return None
    case = next((c for c, want in ATTN_CUTS.items() if dims == want), None)
    if case is None:
        path = "/".join(names)
        raise NotImplementedError(
            f"{path}/{{wq,wk,wv,wo}} cut over \"model\" on dims {dims} "
            f"(from the end; shapes { {k: tuple(tree[k].shape) for k in dims} })"
            ": the attention runs heads, Q and D cuts only")
    return case


def _leaf_cut(names, leaf, dim, cuts) -> Optional[str]:
    """A table's or ``frontend_proj``'s cut name; NotImplementedError for
    a dim the layer code does not run."""
    if dim is None:
        return None
    d = _from_end(dim, leaf.dim())
    if d not in cuts:
        raise NotImplementedError(
            f"{'/'.join(names)} of shape {tuple(leaf.shape)} cut over "
            f"\"model\" on dim {dim}: only {sorted(cuts)} (from the end) run")
    return cuts[d]


def _model_cuts(params, m: int, attn_cases=None):
    """{leaf: (model dim or None, halves)} of a (full) param tree, as
    :func:`shard_params` cuts it over a "model" axis of ``m``; raises
    NotImplementedError for an attention sublayer, a table or
    ``frontend_proj`` on a dim the layer code does not run.  Adds each
    attention sublayer's :data:`ATTN_CUTS` case to the set
    ``attn_cases``, when given."""
    def mamba(tree):
        version = 2 if "bc_proj" in tree else 1
        heads = tree["A_log"].shape[-1] if version == 2 else 0
        if not mamba_splits(tree["conv_w"].shape[-1], heads, m):
            return {k: (None, False) for k in tree}
        dims = _MAMBA_DIM[version]
        return {k: (v.dim() - 1, True) if k == "in_proj"
                else (v.dim() + dims[k], False) for k, v in tree.items()}

    def walk(tree, names):
        if "in_proj" in tree:
            return mamba(tree)
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, names + (k,))
                continue
            sub = names + (k,)
            dim = serving_model_dim(sub, tuple(v.shape), m)
            if dim is None and "moe" in names and k in _EXPERT_LEAVES:
                # f_parallel: every rank holds all experts, a slice of
                # each one's hidden width (w_gate/w_up [.., D, F],
                # w_down [.., F, D])
                f_dim = v.dim() - (2 if k == "w_down" else 1)
                if v.shape[f_dim] % m == 0 and v.shape[f_dim] >= m:
                    dim = f_dim
            if k == "table":
                _leaf_cut(sub, v, dim, TABLE_CUTS)
            elif k == "frontend_proj":
                _leaf_cut(sub, v, dim, FRONTEND_CUTS)
            out[k] = (dim, False)
        if "wq" in tree:
            case = _attn_case(tree, out, names)
            if attn_cases is not None:
                attn_cases.add(case)
        return out

    return walk(params, ())


@functools.lru_cache(maxsize=None)
def model_cuts(cfg, model_size: int) -> ModelCuts:
    """The :class:`ModelCuts` of ``cfg``'s params over a "model" axis of
    ``model_size``: read off the placements :func:`shard_params` gives its
    (abstract, meta-device) param tree, once per config and size."""
    if model_size == 1:
        return WHOLE
    from repro_torch.models import model as M
    # the abstract tree is made outside any dispatch mode: a program
    # being counted (``serving.profiling.measure``) that reaches this first
    # must not count it as its own operators and temporaries
    with _disable_current_modes():
        full = M.init_params(cfg, 0, device="meta")
    attn = set()
    cuts = _model_cuts(full, model_size, attn)
    if len(attn) > 1:
        raise NotImplementedError(f"{cfg.name}: attention sublayers cut "
                                  f"differently over \"model\": {attn}")

    def table(key):
        if key not in full:
            return None
        return _leaf_cut((key, "table"), full[key]["table"],
                         cuts[key]["table"][0], TABLE_CUTS)

    embed = table("embed")
    front = _leaf_cut(("frontend_proj",), full["frontend_proj"],
                      cuts["frontend_proj"][0], FRONTEND_CUTS) \
        if "frontend_proj" in full else None
    return ModelCuts(attn.pop() if attn else None, embed,
                     embed if cfg.tie_embeddings else table("lm_head"), front)


def _fsdp_dim(names: Tuple[str, ...], shape: Tuple[int, ...],
             model_dim: Optional[int], size: int) -> Optional[int]:
    """``param_spec``'s FSDP rule given the model dim the port cuts: the
    largest dim (past a stacked leaf's layer axis) other than ``model_dim``
    that ``size`` divides with at least 4 rows a rank; None for none, or
    for batch axes of size 1."""
    if size == 1:
        return None
    nd = len(shape)
    offset = 1 if (_stacked(names) and nd >= 2) else 0
    for i in sorted(range(offset, nd), key=lambda j: -shape[j]):
        if i != model_dim and shape[i] % size == 0 and shape[i] >= 4 * size:
            return i
    return None


def _placements(params, mesh: Mesh, *, fsdp: bool):
    """The :class:`Placement` of every leaf of a (full) param tree on
    ``mesh``: the serving cut over "model" (:func:`shard_params`) and, with
    ``fsdp``, JAX's ``params_shardings`` FSDP cut of one more dim over the
    batch axes ("pod" and "data"), chosen given the model dim the port
    cuts -- ``param_spec``'s own model dim wherever the port cuts that
    dim, so the FSDP dim lands where JAX's does."""
    m = mesh.shape.get("model", 1)
    b = mesh.axes_size(batch_axes(mesh)) if fsdp else 1
    cuts = _model_cuts(params, m)

    def place(tree, cut, names):
        if isinstance(tree, dict):
            return {k: place(v, cut[k], names + (k,)) for k, v in tree.items()}
        dim, halves = cut
        shape = tuple(tree.shape)
        fdim = _fsdp_dim(names, shape, dim, b)
        replicas = (m if dim is None else 1) * (b if fdim is None else 1)
        return Placement(shape, dim, halves, fdim, replicas)

    return place(params, cuts, ())


class TrainLayout(NamedTuple):
    """A param tree's training placement on ``mesh``: ``placements``
    mirrors the params with each leaf's :class:`Placement` (FSDP on)."""
    mesh: Mesh
    placements: Any

    def fsdp_dims(self):
        """The tree of each leaf's FSDP dim (None: not cut): what
        ``models.model.forward`` gathers over the batch axes."""
        return _map_placements(lambda pl: pl.fsdp_dim, self.placements)


def train_layout(params, mesh: Mesh, *, fsdp: bool = True) -> TrainLayout:
    """The :class:`TrainLayout` of a full param tree (or a tree of anything
    with a ``shape`` and ``dim()``) on ``mesh``; ``fsdp=False`` cuts no
    leaf over the batch axes (every FSDP dim None), as the dry run's
    ``--no-fsdp`` asks."""
    return TrainLayout(mesh, _placements(params, mesh, fsdp=fsdp))


def _map_placements(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_placements(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cut(t: torch.Tensor, pl: Placement, mesh: Mesh) -> torch.Tensor:
    if pl.model_dim is not None:
        m, mi = mesh.shape["model"], mesh.axis_index("model")
        t = _slice_halves(t, m, mi) if pl.halves else _slice(t, pl.model_dim, m, mi)
    if pl.fsdp_dim is not None:
        axes = batch_axes(mesh)
        t = _slice(t, pl.fsdp_dim, mesh.axes_size(axes), mesh.linear_index(axes))
    return t


def shard_params(params, mesh: Mesh, *, fsdp: bool = False):
    """This rank's part of a (full) param tree on ``mesh`` (the counterpart
    of ``params_shardings``): each leaf sliced on its model dim
    (:func:`serving_model_dim`), every other leaf shared as it is.  MoE
    experts slice their expert dim, or (``f_parallel``, when the experts do
    not divide the axis) their hidden width, as ``moe_apply`` reads them.
    A Mamba mixer takes its channels [i di/m, (i+1) di/m) of every leaf
    (``_MAMBA_DIM``; Mamba-2's per-head leaves and ``dt_proj`` the
    matching heads) when :func:`mamba_splits`, else stays whole.
    ``fsdp`` (training) also cuts each leaf's :func:`_fsdp_dim` over the
    batch axes, slice i to the i-th rank of its line (first axis major).
    Also cuts an AdamW moment tree, which has the params' names and
    shapes."""
    return _cut_tree(params, _placements(params, mesh, fsdp=fsdp), mesh)


def _cut_tree(tree, pl, mesh):
    if isinstance(tree, dict):
        return {k: _cut_tree(v, pl[k], mesh) for k, v in tree.items()}
    return _cut(tree, pl, mesh)


def _gather_dim(t: torch.Tensor, dim: int, mesh: Mesh, axes) -> torch.Tensor:
    """The whole of a tensor cut on ``dim`` over ``axes`` (no autograd)."""
    blocks = coll.gather_sum(t.contiguous(), mesh, axes)      # [n, ...]
    return torch.cat(list(blocks.unbind(0)), dim=dim)


@torch.no_grad()
def gather_params(shards, layout: TrainLayout):
    """The inverse of ``shard_params(..., fsdp=True)``: the whole leaves of
    a tree of this rank's shards (params, or an AdamW moment tree), on
    every rank.  Each cut leaf is gathered by SUMs over zero-filled
    buffers, over the batch axes, then over "model"."""
    mesh = layout.mesh

    def whole(t, pl):
        if isinstance(t, dict):
            return {k: whole(v, pl[k]) for k, v in t.items()}
        if pl.fsdp_dim is not None:
            t = _gather_dim(t, pl.fsdp_dim, mesh, batch_axes(mesh))
        if pl.model_dim is not None:
            if pl.halves:
                u, z = t.chunk(2, dim=-1)
                t = torch.cat([_gather_dim(u, -1, mesh, ("model",)),
                               _gather_dim(z, -1, mesh, ("model",))], dim=-1)
            else:
                t = _gather_dim(t, pl.model_dim, mesh, ("model",))
        return t

    return whole(shards, layout.placements)


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------
def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_specs(abs_batch, mesh: Mesh):
    """The spec tree ``data_shardings`` places a batch tree by: the batch
    dim over ("pod","data") when divisible, else replicate the batch and
    shard the sequence dim (long_500k decode).  Leaves may be tensors,
    arrays or anything with a ``shape``.

    This is the JAX package's launcher rule, kept verbatim for callers
    that hold a whole batch tree; it is not the engines' rule.  The model
    and the engines take their block through ``models.sharding.rank_shard``
    (``seq_shard_layout``), as the JAX model code does, and the two rules
    differ where the JAX ones do: here only "data" spills onto a KV
    cache's sequence, there "pod" too."""
    baxes = batch_axes(mesh)
    bsize = int(np.prod([mesh.shape[a] for a in baxes]))
    dsize = mesh.shape.get("data", 1)
    model_size = mesh.shape.get("model", 1)

    def one(names, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        spec: list = [None] * len(shape)
        is_cache = "cache" in names or len(shape) >= 4
        b_dim = 1 if is_cache and len(shape) >= 3 else 0  # caches: [L,B,...]
        b_sharded = False
        if len(shape) > b_dim and shape[b_dim] % bsize == 0 and shape[b_dim] >= bsize:
            spec[b_dim] = baxes if len(baxes) > 1 else baxes[0]
            b_sharded = True
        if len(shape) == 5:
            # KV cache [L,B,S,Hkv,dh]: prefer kv-head dim on "model";
            # else shard the sequence dim (flash-decode style).  If the
            # batch could not shard, the sequence dim also absorbs the
            # data axis.
            s_axes = [] if b_sharded else ["data"]
            if shape[3] % model_size == 0 and shape[3] >= model_size:
                spec[3] = "model"
            else:
                s_axes.append("model")
            div = int(np.prod([mesh.shape[a] for a in s_axes])) if s_axes else 1
            if s_axes and shape[2] % div == 0 and shape[2] >= div:
                spec[2] = tuple(s_axes) if len(s_axes) > 1 else s_axes[0]
        elif len(shape) == 4:
            # SSM state [L,B,di,N] / conv state [L,B,W-1,di]: shard the
            # channel dim on "model"
            for i in (2, 3):
                if shape[i] % model_size == 0 and shape[i] >= model_size:
                    spec[i] = "model"
                    break
        elif len(shape) == 3 and not is_cache and not b_sharded:
            # unbatchable [B,S,D] input (long-context frontend): seq on data
            if shape[1] % dsize == 0 and shape[1] >= dsize:
                spec[1] = "data"
        return tuple(spec)

    return _walk(abs_batch, one)


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (views, no copies)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = mesh.axes_size(axes)
        step = t.shape[dim] // n
        t = t.narrow(dim, mesh.linear_index(axes) * step, step)
    return t


def shard_batch(batch, mesh: Mesh):
    """This rank's block of every leaf of a (replicated) batch tree, by
    :func:`data_specs`."""
    specs = data_specs(batch, mesh)

    def pick(tree, spec):
        if isinstance(tree, dict):
            return {k: pick(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(pick(v, s) for v, s in zip(tree, spec))
        return shard_tensor(tree, spec, mesh)

    return pick(batch, specs)
