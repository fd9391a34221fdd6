"""Cost profile of the continuous serving engine's hot-path programs (the
JAX package's ``repro/serving/profiling.py``).

``profile_engine_programs`` runs each of the engine's programs once on
zero inputs of the engine's shapes -- the fused decode macro-step, the
cross-group splice, the per-slot write and the B=1 prefill -- and returns
flops, bytes accessed and collective bytes per dispatch, in the JAX
schema.  JAX compiles the programs ahead of time and reads XLA's cost
analysis and its HLO; PyTorch runs eagerly and has neither, so the counts
come from the run itself:

* ``flops``: for every operator the program dispatches, its count in
  ``torch.utils.flop_counter``'s registry (the matrix products and
  attention operators PyTorch knows the cost of), as ``FlopCounterMode``
  counts them, read in the same dispatch mode as the bytes (a second mode
  would double the cost of a dry run);
* ``bytes_accessed``: for every PyTorch operator the program dispatches
  that reads or writes tensor data (view and metadata operators left out),
  the bytes of its tensor arguments and of its results, a result that is
  one of its arguments (an in-place update) counted once -- the operator
  by operator sum XLA's "bytes accessed" also is;
* ``collective_bytes``: the :class:`~repro_torch.distributed.collectives.
  CollectiveCounter` over the program, per rank, under the HLO parser's
  names and ``"total"`` (it takes the place of ``collective_bytes(hlo)``).

A hand-written CUDA kernel is launched through its ``ctypes`` binding, not
as a PyTorch operator, so no dispatch mode sees it: each launch (on the
card) or meta stand-in (the dry run) records its ``kernels/costs.py``
flops and bytes instead, which the first two counts add (on the CPU its
plain version runs as operators and is counted as such).  On a mesh every
rank calls this (the programs' collectives are collective) and gets its
own rank's counts.

:func:`measure` is the one counter of a program, here and in the dry run
(``launch/dryrun.py``, on the meta device): besides those counts it
returns, as JAX's ``memory_analysis`` does, the bytes of the program's
arguments and outputs (``numel x element_size`` of each tensor leaf: on the
meta device a shard shares no storage with its whole leaf), the peak live
bytes of the tensors created inside (``temp_size_in_bytes``: each new
storage counted once from the operator or kernel that made it until it is
freed, autograd's saved tensors while they live), the kernels' calls,
flops and bytes by name and the collectives' calls by kind.
``profile_engine_programs`` keeps the JAX schema (flops, bytes accessed,
collective bytes).
"""
from __future__ import annotations

import weakref
from contextlib import nullcontext
from typing import Any, Dict

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives as coll
from repro_torch.kernels import costs
from repro_torch.models.sharding import active_mesh
from repro_torch.serving.engine import splice_slot_caches, write_slot_cache


def _tensors(items) -> list:
    """The tensors among ``items`` and inside their lists and tuples (an
    operator's arguments and results hold no deeper nesting)."""
    found = []
    for x in items:
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, (list, tuple)):
            found += _tensors(x)
    return found


class _OpsMode(TorchDispatchMode):
    """Counts each operator's flops and the tensor bytes each data-moving
    operator reads and writes, and tracks the live bytes of the storages
    created inside; the kernels' records and ``costs.repeats`` reach it as
    a ``kernels/costs.py`` counter."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.kernels = costs.KernelCounter()
        self._seen: set = set()
        self._marks: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        if not func.is_view:
            new = [t for t in outs if not any(t is a for a in ins)]
            self.bytes += float(sum(t.numel() * t.element_size()
                                    for t in ins + new))
        self.track(outs, ins)
        return out

    def track(self, outs, ins=()) -> None:
        """Count each storage of ``outs`` made inside (not one of ``ins``'
        nor one already live) until it is freed."""
        held = None
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            if held is None:
                held = {a.untyped_storage()._cdata for a in ins}
            if key in held:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    # a counter of ``kernels/costs.py``
    def kernel(self, name, cost, outputs=()) -> None:
        self.kernels.kernel(name, cost)
        self.track(_tensors((outputs,)))

    def allocated(self, tensors) -> None:
        self.track(tensors)

    def begin_repeat(self, n: int) -> None:
        self._marks.append((n, self.flops, self.bytes))
        self.kernels.begin_repeat(n)

    def end_repeat(self) -> None:
        n, f0, b0 = self._marks.pop()
        self.flops += (n - 1) * (self.flops - f0)
        self.bytes += (n - 1) * (self.bytes - b0)
        self.kernels.end_repeat()


def tensor_bytes(tree) -> int:
    """``numel x element_size`` summed over the distinct tensor leaves of
    ``tree`` (dicts, tuples, lists, NamedTuples)."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


JAX_KEYS = ("flops", "bytes_accessed", "collective_bytes")


def measure(fn, mesh, args=()) -> Dict[str, Any]:
    """Run ``fn()`` once and count it (module docstring): flops, bytes
    accessed and collective bytes (kernels included), the memory record
    (``args``: the tree of what ``fn`` is handed), the kernels and the
    collective calls."""
    counting = coll.counting(mesh) if mesh is not None \
        else nullcontext(coll.CollectiveCounter())
    with counting as colls, _OpsMode() as ops:
        with costs.counting(ops), costs.counting(colls):
            out = fn()
    k = ops.kernels
    return {"flops": ops.flops + k.sum("flops"),
            "bytes_accessed": ops.bytes + k.sum("bytes"),
            "collective_bytes": colls.totals(),
            "collective_calls": dict(colls.calls),
            "argument_size_in_bytes": tensor_bytes(args),
            "output_size_in_bytes": tensor_bytes(out),
            "temp_size_in_bytes": ops.peak,
            "generated_code_size_in_bytes": None,
            "kernels": k.totals()}


def _measure(fn, mesh, args=()) -> Dict[str, Any]:
    """:func:`measure` in the JAX profile's schema."""
    record = measure(fn, mesh, args)
    return {k: record[k] for k in JAX_KEYS}


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
        return made["logits"], made["cache"]

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
