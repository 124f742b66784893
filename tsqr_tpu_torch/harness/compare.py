"""Mode against mode, and mode against a float64 golden QR.

Counterpart of ``tsqr_tpu/harness/compare.py`` (the reference's
test_compare): the element-wise largest relative difference of Q and R
between two compute modes, and a sign-insensitive comparison with
numpy's float64 LAPACK QR.  The input is uniform[-1, 1] from a
``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from tsqr_tpu_torch.core import blockqr
from tsqr_tpu_torch.harness import accuracy
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils.validation import _host64

Tensor = torch.Tensor


def _max_rel_diff(x: np.ndarray, y: np.ndarray, absolute: bool) -> float:
    if absolute:  # sign-insensitive
        x, y = np.abs(x), np.abs(y)
    denom = np.maximum(np.abs(y), 1e-30)
    return float(np.max(np.abs(x - y) / denom))


def _input(m: int, n: int, seed: int, device, what: str) -> Tensor:
    dev = _device.resolve(device, what)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return accuracy.uniform(m, n, gen, device=dev)


def modes_diff(a: Tensor, mode_a: str, mode_b: str, reorth_a: bool = False,
               reorth_b: bool = False, **qr_kw) -> dict:
    """Largest element-wise relative difference of Q and R between BlockQR
    in two modes on ``a``'s device."""
    qa, ra = blockqr.qr(a, mode_a, reorth=reorth_a, device=a.device, **qr_kw)
    qb, rb = blockqr.qr(a, mode_b, reorth=reorth_b, device=a.device, **qr_kw)
    return {"q_max_rel_diff": _max_rel_diff(_host64(qa), _host64(qb), False),
            "r_max_rel_diff": _max_rel_diff(_host64(ra), _host64(rb), False)}


def golden_diff(a: Tensor, mode: str, reorth: bool = False,
                **qr_kw) -> dict:
    """BlockQR on ``a``'s device against numpy's float64 QR of ``a``,
    sign-insensitive.  Element-wise relative differences of tiny
    off-diagonal R entries say little (they cancel in any precision), so
    R is also judged on its diagonal and relative to its column norms."""
    q, r = blockqr.qr(a, mode, reorth=reorth, device=a.device, **qr_kw)
    qg, rg = np.linalg.qr(_host64(a))
    r64 = _host64(r)
    dg = np.abs(np.diag(rg))
    diag_rel = np.max(np.abs(np.abs(np.diag(r64)) - dg) / dg)
    colnorm = np.maximum(np.linalg.norm(rg, axis=0), 1e-30)
    colscaled = np.max(np.abs(np.abs(r64) - np.abs(rg)) / colnorm[None, :])
    return {"q_max_rel_diff": _max_rel_diff(_host64(q), qg, True),
            "r_max_rel_diff": _max_rel_diff(r64, rg, True),
            "r_diag_max_rel_diff": float(diag_rel),
            "r_colscaled_max_diff": float(colscaled)}


def compare_modes(m: int, n: int, mode_a: str, mode_b: str,
                  reorth_a: bool = False, reorth_b: bool = False,
                  seed: int = 0, device=None, **qr_kw) -> dict:
    """:func:`modes_diff` on a uniform[-1, 1] (m, n) input.  Runs on the
    card unless ``device="cpu"``."""
    return modes_diff(_input(m, n, seed, device, "compare_modes"), mode_a,
                      mode_b, reorth_a, reorth_b, **qr_kw)


def compare_to_fp64_golden(m: int, n: int, mode: str, reorth: bool = False,
                           seed: int = 0, device=None, **qr_kw) -> dict:
    """:func:`golden_diff` on a uniform[-1, 1] (m, n) input.  Runs on the
    card unless ``device="cpu"``."""
    return golden_diff(_input(m, n, seed, device, "compare_to_fp64_golden"),
                       mode, reorth, **qr_kw)
