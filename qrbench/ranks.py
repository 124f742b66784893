"""Start one process a rank, each on its own chip, and collect what each
returns.

The ranks start by the ``spawn`` method and meet through a
``torch.distributed.FileStore`` in a fresh directory under the temporary
directory, which is removed afterwards.  NCCL joins ranks on cards
(its shared-memory transport is switched off, so nothing is written
under ``/dev/shm``; the cards of one host talk over NVLink), gloo ranks
on the CPU.  Each rank sends its result back through a pipe; a rank
that raises, dies or outlives ``timeout`` stops the whole group, and
every process started here has ended when :func:`launch` returns.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback

import torch.multiprocessing as mp


def _main(rank: int, world: int, store_path: str, backend: str, fn, args,
          conn) -> None:
    import torch
    import torch.distributed as dist

    os.environ["NCCL_SHM_DISABLE"] = "1"
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        conn.send((True, out))
    except Exception:  # the rank's failure goes to the parent as text
        conn.send((False, traceback.format_exc()))
    finally:
        conn.close()


def launch(world: int, fn, args=(), backend: str = "nccl",
           timeout: float = 300.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` ranks; the results in rank
    order.  ``fn`` is a module-level function (it is pickled by name)."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="qrbench_ranks_")
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    procs = [ctx.Process(target=_main, daemon=True,
                         args=(r, world, os.path.join(tmp, "store"), backend,
                               fn, args, pipes[r][1]))
             for r in range(world)]
    results: dict[int, object] = {}
    errors: dict[int, str] = {}
    try:
        for p in procs:
            p.start()
        for _, send in pipes:
            send.close()
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < world and not errors:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks not done after {timeout:.0f} s")
            for r, (recv, _) in enumerate(pipes):
                if r in results or r in errors:
                    continue
                if recv.poll(0.2):
                    try:
                        ok, value = recv.recv()
                    except EOFError:
                        errors[r] = f"exit code {procs[r].exitcode}"
                        continue
                    (results if ok else errors)[r] = value
                elif procs[r].exitcode is not None:
                    errors[r] = f"exit code {procs[r].exitcode}"
        if errors:
            raise RuntimeError("rank(s) failed:\n" + "\n".join(
                f"--- rank {r} ---\n{msg}" for r, msg in sorted(errors.items())))
        for p in procs:
            p.join(timeout=60)
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        for recv, _ in pipes:
            recv.close()
        shutil.rmtree(tmp, ignore_errors=True)
