"""Cost profile of the continuous serving engine's hot-path programs (the
JAX package's ``repro/serving/profiling.py``).

``profile_engine_programs`` runs each of the engine's programs once on
zero inputs of the engine's shapes -- the fused decode macro-step, the
cross-group splice, the per-slot write and the B=1 prefill -- and returns
flops, bytes accessed and collective bytes per dispatch, in the JAX
schema.  JAX compiles the programs ahead of time and reads XLA's cost
analysis and its HLO; PyTorch runs eagerly and has neither, so the counts
come from the run itself:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (the matrix
  products and attention operators PyTorch knows the cost of);
* ``bytes_accessed``: for every PyTorch operator the program dispatches
  that reads or writes tensor data (view and metadata operators left out),
  the bytes of its tensor arguments and of its results, a result that is
  one of its arguments (an in-place update) counted once -- the operator
  by operator sum XLA's "bytes accessed" also is;
* ``collective_bytes``: the :class:`~repro_torch.distributed.collectives.
  CollectiveCounter` over the program, per rank, under the HLO parser's
  names and ``"total"`` (it takes the place of ``collective_bytes(hlo)``).

A hand-written CUDA kernel is launched through its ``ctypes`` binding, not
as a PyTorch operator, so on the card its flops and bytes are not in the
first two counts (on the CPU its plain version runs as operators and is).
On a mesh every rank calls this (the programs' collectives are collective)
and gets its own rank's counts.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import collectives as coll
from repro_torch.models.sharding import active_mesh
from repro_torch.serving.engine import splice_slot_caches, write_slot_cache


class _BytesMode(TorchDispatchMode):
    """Sums the tensor bytes each data-moving operator reads and writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)
                    and not any(t is a for a in ins)]
            self.bytes += float(sum(t.numel() * t.element_size()
                                    for t in ins + outs))
        return out


def _measure(fn, mesh) -> Dict[str, Any]:
    counting = coll.counting(mesh) if mesh is not None else nullcontext()
    with counting as counter, FlopCounterMode(display=False) as flops, \
            _BytesMode() as moved:
        fn()
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": moved.bytes,
            "collective_bytes": counter.totals() if counter is not None
            else coll.CollectiveCounter().totals()}


@torch.no_grad()
def profile_engine_programs(engine, *, prompt_len: int,
                            n_blocks: int = 2) -> Dict[str, Any]:
    """Per-dispatch cost decomposition of a continuous engine's hot path.

    Programs:

    * ``decode_loop`` -- one fused ``macro_steps``-token decode dispatch
      over every slot (the per-macro-step device cost, collectives
      included);
    * ``splice``      -- the fused cross-group splice of ``n_blocks`` B=1
      KV blocks (disaggregated boundary);
    * ``slot_write``  -- one per-slot big-cache write (local boundary);
    * ``prefill``     -- one B=1 shadow prefill.

    Each runs once on zero inputs (a fresh cache and state of the engine's
    shapes; the engine's own state is not touched).  Call it on the mesh
    the engine serves on (inside ``activation_sharding(mesh)``), on every
    rank."""
    cfg, dev = engine.cfg, engine.device
    mesh = active_mesh()
    K = max(engine.macro_steps, 1)
    slots = engine.slots
    m_blocks = max(1, min(n_blocks, slots))
    batch = {"tokens": torch.zeros((1, prompt_len), dtype=torch.int32,
                                   device=dev)}
    if cfg.frontend:         # the vlm's patch rows, the audio model's frames
        batch["frontend"] = torch.zeros(
            (1, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model),
            dtype=cfg.torch_dtype, device=dev)
    cache, cur_tok, lengths, remaining, done = engine._init_state()
    done.zero_()                     # every slot decodes
    remaining.fill_(K)
    ids = torch.zeros((m_blocks,), dtype=torch.int32, device=dev)
    made: Dict[str, Any] = {}

    def prefill():
        made["logits"], made["cache"] = engine.prefill(engine.params, batch)

    programs = {"prefill": _measure(prefill, mesh)}
    pre = made["cache"]
    programs["decode_loop"] = _measure(
        lambda: engine._get_loop(K)(engine.params, cache, cur_tok, lengths,
                                    remaining, done, engine._shard), mesh)
    programs["splice"] = _measure(
        lambda: splice_slot_caches(cfg, cache, [pre] * m_blocks, ids,
                                   engine._shard), mesh)
    programs["slot_write"] = _measure(
        lambda: write_slot_cache(cfg, cache, pre, 0, engine._shard), mesh)
    return {
        "device_count": mesh.size if mesh is not None else 1,
        "macro_steps": K,
        "slots": slots,
        "n_blocks": m_blocks,
        "prompt_len": prompt_len,
        "programs": programs,
    }
