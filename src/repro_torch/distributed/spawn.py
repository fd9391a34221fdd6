"""Run a function on N ranks, one process each, and collect their results.

``run_ranks(fn, world, *args)`` starts ``world`` processes with the spawn
start method; each joins a process group (``init_method="file://..."`` in a
fresh temporary directory, so concurrent runs never share a port) with a
timeout, calls ``fn(rank, world, *args)`` and sends its (picklable) result
back.  Any rank's exception fails the whole run with that rank's
traceback; a run that outlasts ``timeout_s`` is killed and fails.  ``fn``
must be importable by name (a module-level function).
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.mesh import GROUP_TIMEOUT_S


def _rank_main(fn, rank: int, world: int, backend: str, init_file: str,
               results, threads: Optional[int], args) -> None:
    try:
        if threads:
            import torch
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, *args,
              backend: str = "gloo", timeout_s: float = 2 * GROUP_TIMEOUT_S,
              threads: Optional[int] = None) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process.  ``threads`` sets each rank's intra-op thread
    count (``torch.set_num_threads``)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    init_file = os.path.join(tmp, "init")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init_file, results,
                               threads, args), daemon=True)
             for r in range(world)]
    outs: dict = {}
    errors: List[str] = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(outs) + len(errors) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, out = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                if left <= 0 or not any(p.is_alive() for p in procs):
                    break
                continue
            if ok:
                outs[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break       # the other ranks may now wait on it: stop all
        for p in procs:
            p.join(timeout=5 if errors or len(outs) < world else 30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    if len(outs) < world:
        missing = sorted(set(range(world)) - set(outs))
        codes = {r: procs[r].exitcode for r in missing}
        raise RuntimeError(f"ranks {missing} returned no result within "
                           f"{timeout_s:.0f} s (exit codes {codes})")
    return [outs[r] for r in range(world)]
