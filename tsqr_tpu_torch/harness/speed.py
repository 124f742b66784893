"""Speed of BlockQR on the card: elapsed time, model TFLOP/s and the
tree's working memory, as CSV.

Counterpart of ``tsqr_tpu/harness/speed.py``, with its CSV schema
``m,n,type,compute_mode,reorthogonalization,elapsed_time,tflops,
working_memory_size``.  Each row times ``blockqr.qr`` on a uniform[-1, 1]
float32 input on the card (median of ``trials`` CUDA-event timings after
one warm-up), with the tree's defaults: the panel kernel leaf at its
largest tile and fan-in ``tsqr.DEFAULT_FANIN``.

    python -m tsqr_tpu_torch.harness.main speed [--quick]
"""

from __future__ import annotations

import statistics
import sys
from typing import IO, Sequence

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr, tsqr as tsqr_mod
from tsqr_tpu_torch.harness import flops as flops_mod
from tsqr_tpu_torch.utils import status, timing

CSV_HEADER = ("m,n,type,compute_mode,reorthogonalization,elapsed_time,"
              "tflops,working_memory_size")


def speed_row(m: int, n: int, mode: str, reorth: bool = False,
              trials: int = 8, seed: int = 0, panel_width: int = 128,
              fanin: int = tsqr_mod.DEFAULT_FANIN) -> dict:
    policy = modes.resolve(mode)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
    elapsed = statistics.median(timing.time_cuda(
        lambda: blockqr.qr(a, policy, reorth=reorth, panel_width=panel_width,
                           fanin=fanin), reps=trials, warmup=1)) / 1e3
    w = min(n, panel_width)
    leaf = flops_mod.default_leaf_rows(w)
    fl = flops_mod.blockqr_flops(m, n, panel_width, leaf, fanin, reorth)
    wmem = tsqr_mod.working_memory_elems(m, w, leaf, fanin) * 4
    return {"m": m, "n": n, "type": "float32", "compute_mode": policy.name,
            "reorthogonalization": int(reorth), "elapsed_time": elapsed,
            "tflops": fl / elapsed / 1e12, "working_memory_size": wmem}


def format_row(row: dict) -> str:
    return (f"{row['m']},{row['n']},{row['type']},{row['compute_mode']},"
            f"{row['reorthogonalization']},{row['elapsed_time']:.6e},"
            f"{row['tflops']:.4f},{row['working_memory_size']}")


def sweep(ms: Sequence[int], ns: Sequence[int], mode_names: Sequence[str],
          reorths: Sequence[bool] = (False,), out: IO = sys.stdout,
          **kw) -> tuple[list[dict], list[str]]:
    """Every (mode, reorth, m, n) with n <= m; a row that fails prints a
    '# error' line and the sweep goes on.  Returns (rows, errors)."""
    print(CSV_HEADER, file=out, flush=True)
    rows, errors = [], []
    for mode in mode_names:
        for reorth in reorths:
            for m in ms:
                for n in ns:
                    if n > m:
                        continue
                    try:
                        row = speed_row(m, n, mode, reorth, **kw)
                    except Exception as e:  # noqa: BLE001 (sweep goes on)
                        note = (f"# error m={m} n={n} mode={mode}: "
                                f"{status.exc_note(e)}")
                        errors.append(note)
                        print(note, file=out, flush=True)
                        continue
                    rows.append(row)
                    print(format_row(row), file=out, flush=True)
    return rows, errors
