"""Checkpointing: save / restore param and optimizer trees to ``.npz`` in
the JAX package's layout (``repro/training/checkpoint.py``).

Flat key paths as JAX's ``_flatten`` spells them (``params/blocks/attn/wq``;
the ``OptState`` fields as ``opt/.step``, ``opt/.m/...``, ``opt/.v/...``)
plus a ``__manifest__`` JSON string with the metadata.  The write is atomic:
a temporary file in the target's directory, then a rename.

A bf16 leaf is written as JAX writes one: numpy stores ml_dtypes'
``bfloat16`` as raw 2-byte ``|V2`` records, and so does this module,
without ml_dtypes.  On restore such a leaf is read back by a bit view
against the template's bf16, which is exact, and which also reads the bf16
files that JAX's own ``restore_checkpoint`` refuses
(``jnp.asarray(arr, bfloat16)``: "No cast function available").

On a mesh (``layout``, a ``launch.mesh.TrainLayout``; the trees hold this
rank's ``shard_params(fsdp=True)`` shards) the save gathers every leaf
whole (``launch.mesh.gather_params``, every rank takes part) and the
mesh's first rank writes the file one device would write from the same
whole params; the restore reads whole leaves on every rank and cuts this
rank's shards.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import gather_params, shard_params


def named_leaves(tree, prefix: str = ""):
    """(key path, leaf) pairs in JAX's flattening order and spelling: dict
    keys sorted, a NamedTuple's fields as ``.name`` (``str`` of JAX's
    ``GetAttrKey``), tuple and list positions as their index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from named_leaves(v, f"{prefix}.{name}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"cannot read a {arr.dtype} leaf: only 2-byte "
                             "records (bf16) are known")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        # arrays read from a file are writable; copy only one that is not
        t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
    return t.to(like.device, like.dtype)


def save_checkpoint(path: str, params, opt_state=None,
                    metadata: Optional[dict] = None, *, layout=None) -> None:
    """Write ``params`` (and ``opt_state``) to ``path``; on a mesh
    (``layout``) gather them whole and write on its first rank only."""
    if layout is not None:
        mesh = layout.mesh
        params = gather_params(params, layout)
        if opt_state is not None:
            opt_state = type(opt_state)(opt_state.step,
                                        gather_params(opt_state.m, layout),
                                        gather_params(opt_state.v, layout))
        if mesh.rank == int(mesh.ranks.flat[0]):
            save_checkpoint(path, params, opt_state, metadata)
        group = mesh.group(mesh.axes)
        if group is not None:          # the file exists when any rank returns
            dist.barrier(group=group)
        return
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    payload = {"params/" + k: _to_numpy(v) for k, v in named_leaves(params)}
    if opt_state is not None:
        payload.update({"opt/" + k: _to_numpy(v)
                        for k, v in named_leaves(opt_state)})
    manifest = {
        "metadata": metadata or {},
        "params_treedef": " ".join(k for k, _ in named_leaves(params)),
        "has_opt": opt_state is not None,
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __manifest__=json.dumps(manifest), **payload)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _rebuild(template, flat: Dict[str, np.ndarray], prefix: str, path=""):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], flat, prefix, f"{path}{k}/")
                for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _rebuild(v, flat, prefix, f"{path}.{name}/")
            for name, v in zip(template._fields, template)))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, flat, prefix, f"{path}{i}/")
                              for i, v in enumerate(template))
    key = prefix + path[:-1]
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, the "
                         f"template {tuple(template.shape)}")
    return _from_numpy(arr, template)


def _whole_like(tree, placements):
    """Empty tensors of the whole leaves' shapes, in the shards' dtypes and
    devices (the templates a mesh restore reads into)."""
    if isinstance(tree, dict):
        return {k: _whole_like(v, placements[k]) for k, v in tree.items()}
    return torch.empty(placements.shape, dtype=tree.dtype, device=tree.device)


def restore_checkpoint(path: str, params_like, opt_like=None, *, layout=None
                       ) -> Tuple[Any, Any, dict]:
    """Restore into the structure, dtypes and devices of the
    ``params_like`` / ``opt_like`` templates: (params, opt_state or None,
    metadata).  On a mesh (``layout``) the templates are shards: whole
    leaves are read and this rank's shards cut from them."""
    if layout is not None:
        pl = layout.placements
        whole_opt = None if opt_like is None else type(opt_like)(
            opt_like.step, _whole_like(opt_like.m, pl), _whole_like(opt_like.v, pl))
        params, opt, meta = restore_checkpoint(
            path, _whole_like(params_like, pl), whole_opt)
        params = shard_params(params, layout.mesh, fsdp=True)
        if opt is not None:
            opt = type(opt)(opt.step, shard_params(opt.m, layout.mesh, fsdp=True),
                            shard_params(opt.v, layout.mesh, fsdp=True))
        return params, opt, meta
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        flat = {k: z[k] for k in z.files if k != "__manifest__"}
    params = _rebuild(params_like, flat, "params/")
    opt = None
    if opt_like is not None and manifest["has_opt"]:
        opt = _rebuild(opt_like, flat, "opt/")
    return params, opt, manifest["metadata"]
