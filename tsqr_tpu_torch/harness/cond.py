"""Robustness of BlockQR against the condition number: CSV rows in the
reference's schema.

Counterpart of ``tsqr_tpu/harness/cond.py``: a sweep over target
condition numbers (the reference's: kappa = 2^2 .. 2^15 at m = 2^15,
n = 2^7) on latms matrices whose condition number is measured
(``utils/latms.py``, made with numpy from ``seed``); CSV ``m,n,
condition,measured_condition,type,compute_mode,reorthogonalization,
residual,...``.  mode "golden" runs ``torch.linalg.qr`` (cuSOLVER on the
card) on the same matrices, as the reference judges every cond sweep
against the vendor QR.

    python -m tsqr_tpu_torch.harness.main cond [--quick]
"""

from __future__ import annotations

import sys
from typing import IO, Sequence

import numpy as np
import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr
from tsqr_tpu_torch.harness import accuracy
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils import latms, status, validation

CSV_HEADER = ("m,n,condition,measured_condition,type,compute_mode,"
              "reorthogonalization,residual,residual_variance,"
              "orthogonality,orthogonality_variance")
GOLDEN_NAME = "torch.linalg.qr"


def cond_trial(a: torch.Tensor, mode: str, reorth: bool = False,
               **qr_kw) -> tuple[float, float]:
    """One trial on the input ``a``: BlockQR (``torch.linalg.qr`` for
    mode "golden") on ``a``'s device, then (residual, orthogonality) in
    float64 on the host."""
    if mode == "golden":
        q, r = torch.linalg.qr(a)
    else:
        q, r = blockqr.qr(a, mode, reorth=reorth, device=a.device, **qr_kw)
    return validation.residual(a, q, r), validation.orthogonality(q)


def cond_row(m: int, n: int, cond: float, mode: str, reorth: bool = False,
             trials: int = 4, seed: int = 0, device=None, **qr_kw) -> dict:
    """One (kappa, mode) config over ``trials`` latms matrices.  Runs on
    the card unless ``device="cpu"``."""
    dev = _device.resolve(device, "cond_row")
    if mode == "golden":
        name, reorth = GOLDEN_NAME, False
    else:
        name = modes.resolve(mode).name
    rng = np.random.default_rng(seed)
    residuals, orths, measured = [], [], []
    for _ in range(trials):
        a_np, mc = latms.rand_matrix_with_cond(rng, m, n, cond)
        res, orth = cond_trial(torch.from_numpy(a_np).to(dev), mode, reorth,
                               **qr_kw)
        residuals.append(res)
        orths.append(orth)
        measured.append(mc)
    return {"m": m, "n": n, "condition": cond,
            "measured_condition": float(np.mean(measured)),
            "type": "float32", "compute_mode": name,
            "reorthogonalization": int(reorth),
            **accuracy.summary(residuals, orths)}


def format_row(row: dict) -> str:
    return (f"{row['m']},{row['n']},{row['condition']:.6e},"
            f"{row['measured_condition']:.6e},{row['type']},"
            f"{row['compute_mode']},{row['reorthogonalization']},"
            f"{row['residual']:.6e},{row['residual_variance']:.6e},"
            f"{row['orthogonality']:.6e},{row['orthogonality_variance']:.6e}")


def sweep(m: int, n: int, conds: Sequence[float],
          mode_names: Sequence[str], reorths: Sequence[bool] = (False, True),
          out: IO = sys.stdout, **kw) -> tuple[list[dict], list[str]]:
    """Every (mode, reorth, kappa); "golden" rows have no reorth variant.
    A config that fails prints a '# error' line and the sweep goes on.
    Returns (rows, errors)."""
    print(CSV_HEADER, file=out, flush=True)
    rows, errors = [], []
    for mode in mode_names:
        for reorth in reorths:
            if mode == "golden" and reorth:
                continue
            for cond in conds:
                try:
                    row = cond_row(m, n, cond, mode, reorth, **kw)
                except Exception as e:  # noqa: BLE001 (sweep goes on)
                    note = (f"# error cond={cond} mode={mode}: "
                            f"{status.exc_note(e)}")
                    errors.append(note)
                    print(note, file=out, flush=True)
                    continue
                rows.append(row)
                print(format_row(row), file=out, flush=True)
    return rows, errors
