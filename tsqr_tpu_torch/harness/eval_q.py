"""Quality of BlockQR's Q: the diagonal and off-diagonal parts of the
orthogonality error.

Counterpart of ``tsqr_tpu/harness/eval_q.py`` (the reference's eval_q
study): ||Q^T Q - I||_F / sqrt(n) split into its diagonal part (the
columns' normalisation) and its off-diagonal part (their mutual
orthogonality), which the correction modes mainly repair.  CSV
``m,n,compute_mode,reorthogonalization,diag,offdiag``.  The input is
uniform[-1, 1] from a ``torch.Generator`` seeded with ``seed``.

    python -m tsqr_tpu_torch.harness.main eval_q [--quick]
"""

from __future__ import annotations

import sys
from typing import IO, Sequence

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr
from tsqr_tpu_torch.harness import accuracy
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils import validation

CSV_HEADER = "m,n,compute_mode,reorthogonalization,diag,offdiag"


def eval_q_trial(a: torch.Tensor, mode, reorth: bool = False,
                 **qr_kw) -> tuple[float, float]:
    """BlockQR of ``a`` on its device; (diag, offdiag) of Q's
    orthogonality error in float64 on the host."""
    q, _ = blockqr.qr(a, mode, reorth=reorth, device=a.device, **qr_kw)
    return validation.orthogonality_each(q)


def eval_q_row(m: int, n: int, mode: str, reorth: bool = False,
               seed: int = 0, device=None, **qr_kw) -> dict:
    """One config.  Runs on the card unless ``device="cpu"``."""
    policy = modes.resolve(mode)
    dev = _device.resolve(device, "eval_q_row")
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, off = eval_q_trial(accuracy.uniform(m, n, gen, device=dev), policy,
                          reorth, **qr_kw)
    return {"m": m, "n": n, "compute_mode": policy.name,
            "reorthogonalization": int(reorth), "diag": d, "offdiag": off}


def format_row(row: dict) -> str:
    return (f"{row['m']},{row['n']},{row['compute_mode']},"
            f"{row['reorthogonalization']},{row['diag']:.6e},"
            f"{row['offdiag']:.6e}")


def sweep(ms: Sequence[int], n: int, mode_names: Sequence[str],
          reorths: Sequence[bool] = (False, True), out: IO = sys.stdout,
          **kw) -> list[dict]:
    """Every (mode, reorth, m) at width ``n``."""
    print(CSV_HEADER, file=out, flush=True)
    rows = []
    for mode in mode_names:
        for reorth in reorths:
            for m in ms:
                row = eval_q_row(m, n, mode, reorth, **kw)
                rows.append(row)
                print(format_row(row), file=out, flush=True)
    return rows
