"""The vendor QR measured as the library is: accuracy and speed rows in
the harness's schemas.

Counterpart of ``tsqr_tpu/harness/baseline.py`` (the reference's
cusolver_accuracy / cusolver_speed).  The baseline is
``torch.linalg.qr``, cuSOLVER's geqrf + orgqr on the card, where the JAX
package measures ``jnp.linalg.qr``; the rows use ``harness/accuracy.py``'s
and ``harness/speed.py``'s CSV schemas unchanged, with compute_mode
"torch.linalg.qr".

    python -m tsqr_tpu_torch.harness.main baseline [--quick]
"""

from __future__ import annotations

import sys
from typing import IO, Sequence

import torch

from tsqr_tpu_torch.harness import accuracy as accuracy_mod
from tsqr_tpu_torch.harness import flops as flops_mod
from tsqr_tpu_torch.harness import speed as speed_mod
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils import timing

NAME = "torch.linalg.qr"


def baseline_accuracy_row(m: int, n: int, rand_range: float = 1.0,
                          trials: int = 16, seed: int = 0,
                          device=None) -> dict:
    """``trials`` uniform inputs through ``torch.linalg.qr``; metrics in
    float64 on the host.  Runs on the card unless ``device="cpu"``."""
    dev = _device.resolve(device, "baseline_accuracy_row")
    gen = torch.Generator(device=dev).manual_seed(seed)
    residuals, orths = [], []
    for _ in range(trials):
        a = accuracy_mod.uniform(m, n, gen, rand_range, dev)
        q, r = torch.linalg.qr(a)
        res, orth = accuracy_mod.metrics_of(a, q, r, "host")
        residuals.append(res)
        orths.append(orth)
    return {"m": m, "n": n, "rand_range": rand_range, "type": "float32",
            "compute_mode": NAME, "reorthogonalization": 0,
            **accuracy_mod.summary(residuals, orths)}


def baseline_speed_row(m: int, n: int, trials: int = 4, seed: int = 0,
                       device=None, **_ignored) -> dict:
    """Seconds per ``torch.linalg.qr`` call (``timing.time_fn_amortized``,
    max(2, trials) calls a window) and model TFLOP/s.  Runs on the card
    unless ``device="cpu"``."""
    dev = _device.resolve(device, "baseline_speed_row")
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = accuracy_mod.uniform(m, n, gen, device=dev)
    elapsed = timing.time_fn_amortized(torch.linalg.qr, a,
                                       loops=max(2, trials), reps=2)
    return {"m": m, "n": n, "type": "float32", "compute_mode": NAME,
            "reorthogonalization": 0, "elapsed_time": elapsed,
            "tflops": flops_mod.qr_flops(m, n) / elapsed / 1e12,
            "working_memory_size": 0}


def accuracy_sweep(ms: Sequence[int], ns: Sequence[int], trials: int = 16,
                   out: IO = sys.stdout, device=None) -> list[dict]:
    print(accuracy_mod.CSV_HEADER, file=out, flush=True)
    rows = []
    for m in ms:
        for n in ns:
            if n > m:
                continue
            row = baseline_accuracy_row(m, n, trials=trials, device=device)
            rows.append(row)
            print(accuracy_mod.format_row(row), file=out, flush=True)
    return rows


def speed_sweep(ms: Sequence[int], ns: Sequence[int],
                out: IO = sys.stdout, device=None) -> list[dict]:
    print(speed_mod.CSV_HEADER, file=out, flush=True)
    rows = []
    for m in ms:
        for n in ns:
            if n > m:
                continue
            row = baseline_speed_row(m, n, device=device)
            rows.append(row)
            print(speed_mod.format_row(row), file=out, flush=True)
    return rows
