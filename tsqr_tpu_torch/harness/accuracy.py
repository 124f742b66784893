"""Statistical accuracy of BlockQR: CSV rows in the reference's schema.

Counterpart of ``tsqr_tpu/harness/accuracy.py``: ``trials`` random
inputs per (m, n, rand_range) config, the mean and variance of the
relative residual ||A - QR||_F / ||A||_F and of the orthogonality
||Q^T Q - I||_F / sqrt(n); CSV ``m,n,rand_range,type,compute_mode,
reorthogonalization,residual,residual_variance,orthogonality,
orthogonality_variance``, a row flushed per config so that a cut sweep
keeps what it measured.  Inputs are uniform[-rand_range, rand_range]
from a ``torch.Generator`` seeded with ``seed``: other values than
``jax.random``'s, the same distribution.

    python -m tsqr_tpu_torch.harness.main accuracy [--quick]
"""

from __future__ import annotations

import sys
from typing import IO, Sequence

import numpy as np
import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils import status, validation

CSV_HEADER = ("m,n,rand_range,type,compute_mode,reorthogonalization,"
              "residual,residual_variance,orthogonality,"
              "orthogonality_variance")

# "auto" metrics: float64 on the host up to this many elements, the
# chunked float32 device metrics above (the host copy stops scaling)
HOST_METRICS_MAX_ELEMS = 1 << 26


def uniform(m: int, n: int, gen: torch.Generator, rand_range: float = 1.0,
            device=None) -> torch.Tensor:
    """(m, n) float32 uniform[-rand_range, rand_range] from ``gen``."""
    return torch.empty(m, n, device=device).uniform_(
        -rand_range, rand_range, generator=gen)


def metrics_of(a: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
               metrics: str) -> tuple[float, float]:
    """(residual, orthogonality) of one factorization: "host" in float64
    on the host, "device" by the chunked float32 device metrics
    (``residual_device_chunked``, ``orthogonality_wide_device``)."""
    if metrics == "device":
        return (float(validation.residual_device_chunked(a, q, r)),
                float(validation.orthogonality_wide_device(q)))
    if metrics != "host":
        raise ValueError(f"unknown metrics {metrics!r}")
    return validation.residual(a, q, r), validation.orthogonality(q)


def resolve_metrics(metrics: str, m: int, n: int) -> str:
    if metrics == "auto":
        return "host" if m * n <= HOST_METRICS_MAX_ELEMS else "device"
    return metrics


def accuracy_trial(a: torch.Tensor, mode, reorth: bool = False,
                   metrics: str = "host", **qr_kw) -> tuple[float, float]:
    """One trial on the input ``a``: BlockQR on ``a``'s device, then
    (residual, orthogonality) by ``metrics``."""
    q, r = blockqr.qr(a, mode, reorth=reorth, device=a.device, **qr_kw)
    return metrics_of(a, q, r, metrics)


def summary(residuals, orths) -> dict:
    residuals, orths = np.array(residuals), np.array(orths)
    return {"residual": residuals.mean(),
            "residual_variance": residuals.var(),
            "orthogonality": orths.mean(),
            "orthogonality_variance": orths.var()}


def accuracy_row(m: int, n: int, mode: str, reorth: bool = False,
                 rand_range: float = 1.0, trials: int = 16, seed: int = 0,
                 metrics: str = "auto", device=None, **qr_kw) -> dict:
    """One config: ``trials`` random inputs, the mean and variance of both
    metrics.  Runs on the card unless ``device="cpu"``.

    metrics: "host" (float64 on the host, the golden path), "device"
    (the chunked float32 device metrics, calibrated against it) or
    "auto" (host up to m n = 2^26 elements)."""
    policy = modes.resolve(mode)
    dev = _device.resolve(device, "accuracy_row")
    metrics = resolve_metrics(metrics, m, n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    residuals, orths = [], []
    for _ in range(trials):
        a = uniform(m, n, gen, rand_range, dev)
        res, orth = accuracy_trial(a, policy, reorth, metrics, **qr_kw)
        residuals.append(res)
        orths.append(orth)
    return {"m": m, "n": n, "rand_range": rand_range, "type": "float32",
            "compute_mode": policy.name, "reorthogonalization": int(reorth),
            **summary(residuals, orths)}


def format_row(row: dict) -> str:
    return (f"{row['m']},{row['n']},{row['rand_range']},{row['type']},"
            f"{row['compute_mode']},{row['reorthogonalization']},"
            f"{row['residual']:.6e},{row['residual_variance']:.6e},"
            f"{row['orthogonality']:.6e},{row['orthogonality_variance']:.6e}")


def sweep(ms: Sequence[int], ns: Sequence[int], mode_names: Sequence[str],
          reorths: Sequence[bool] = (False,), trials: int = 16,
          out: IO = sys.stdout, **qr_kw) -> tuple[list[dict], list[str]]:
    """Every (mode, reorth, m, n) with n <= m; a config that fails prints
    a '# error' line and the sweep goes on.  Returns (rows, errors)."""
    print(CSV_HEADER, file=out, flush=True)
    rows, errors = [], []
    for mode in mode_names:
        for reorth in reorths:
            for m in ms:
                for n in ns:
                    if n > m:
                        continue
                    try:
                        row = accuracy_row(m, n, mode, reorth,
                                           trials=trials, **qr_kw)
                    except Exception as e:  # noqa: BLE001 (sweep goes on)
                        note = (f"# error m={m} n={n} mode={mode}: "
                                f"{status.exc_note(e)}")
                        errors.append(note)
                        print(note, file=out, flush=True)
                        continue
                    rows.append(row)
                    print(format_row(row), file=out, flush=True)
    return rows, errors
