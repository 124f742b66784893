"""Start a process group: one process a rank, joined with a time limit.

:func:`spawn` runs ``target(rank, world, *args)`` in ``world`` processes
started with the ``spawn`` method, each in a ``torch.distributed`` group
that meets through a ``FileStore`` in a fresh temporary directory (no
TCP port to clash with another group).  It returns each rank's result,
and raises if any rank fails or the group outlives ``timeout``: then
every rank is killed.  A rank that hangs in a collective, because
another took a branch it did not, is a failure too.

Backend: NCCL when the ranks run on the card and there is a card for
each (a one-rank group too), gloo otherwise: NCCL takes one rank a
card, so several ranks on one card run over gloo (``parallel/comm.py``
stages their payloads through host memory).
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def pick_backend(world: int, device: str) -> str:
    """"nccl" for ranks on cards with a card each, else "gloo"."""
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               device: str, target, args, results) -> None:
    torch.set_num_threads(1)
    try:
        if device == "cuda":
            # NCCL: a card a rank; gloo: every rank on card 0
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            out = target(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor put on the queue as it is would be shared
        # through a file descriptor that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # the rank's failure goes to the parent as text
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(world: int, target, args=(), backend: str | None = None,
          device: str = "cuda", timeout: float = 600.0) -> list:
    """Run ``target(rank, world, *args)`` on ``world`` ranks and return
    the ranks' results in rank order.

    ``target`` and ``args`` are pickled to the children (a module-level
    function, by its import path); a result comes back pickled by value,
    so keep it small (numbers, numpy arrays, CPU tensors).  ``device`` is
    "cuda" (the default) or "cpu"; ``backend`` None picks :func:`pick_backend`.  Raises
    ``RuntimeError`` with the failing ranks' tracebacks if a rank raises
    or dies, and ``TimeoutError`` if the ranks are not done within
    ``timeout`` seconds; either way every rank is killed first."""
    backend = backend or pick_backend(world, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="tsqr_dist_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "store"), backend,
                               device, target, args, results), daemon=True)
             for r in range(world)]
    out: dict[int, object] = {}
    errors: dict[int, str] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) + len(errors) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn: {world - len(out)} of {world} ranks not done "
                        f"after {timeout:.0f} s (a hung collective?)")
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in errors]
                if dead:
                    # died without a word (killed, or a crash in C++)
                    errors.update({r: f"exit code {procs[r].exitcode}"
                                   for r in dead})
                continue
            if ok:
                out[rank] = pickle.loads(value)   # this group's own bytes
            else:
                errors[rank] = value
            if errors:
                break
        if errors:
            raise RuntimeError("spawn: rank(s) failed:\n" + "\n".join(
                f"--- rank {r} ---\n{msg}"
                for r, msg in sorted(errors.items())))
        for p in procs:
            p.join(timeout=30)
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
