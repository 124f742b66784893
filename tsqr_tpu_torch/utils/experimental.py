"""Numerical fault injection: forced exponent clamping.

Counterpart of ``tsqr_tpu/utils/experimental.py``.  ``min_exponent``
flushes elements whose binary exponent lies below a threshold to zero,
``clamp_exponent_range`` also clips magnitudes above a ceiling, so that
float32 data carries only a narrower format's exponent range (fp16's
[-14, 15]).  ``fp16_range_study`` runs a QR on the data as given and on
its fp16-range image, the reference's underflow experiment
(EVALUATE_EXPONENT_DISTRIBUTION) as one call.  bf16 and the corrected
modes keep float32's exponent range, so this is a validation study, not
a correctness gate.  Every result agrees bit for bit with the JAX
package's on the same float32 values.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tsqr_tpu_torch.utils import validation

Tensor = torch.Tensor


# float32's normal exponent range: the reference computes on devices that
# flush subnormals (the TPU, and XLA on the CPU), so its float32 2^e is 0
# below it and its clip returns a subnormal as a zero of the same sign
_NORMAL_MIN_EXP, _MAX_EXP = -126, 127


def _pow2(e: int) -> float:
    """2^e as the reference's float32 power gives it."""
    if e < _NORMAL_MIN_EXP:
        return 0.0
    return math.ldexp(1.0, e) if e <= _MAX_EXP else math.inf


def min_exponent(x: Tensor, min_exp: int) -> Tensor:
    """``x`` as float32 with every element of magnitude below
    2^min_exp set to +0 (flush to zero at a chosen threshold)."""
    x = torch.as_tensor(x).to(torch.float32)
    return torch.where(x.abs() < _pow2(min_exp), 0.0, x)


def clamp_exponent_range(x: Tensor, min_exp: int, max_exp: int) -> Tensor:
    """``x`` as float32 with magnitudes below 2^min_exp flushed to +0 and
    magnitudes above 2^max_exp clipped to +-2^max_exp (subnormals that
    survive come out as signed zeros, as from the reference's clip)."""
    hi = _pow2(max_exp)
    y = torch.clamp(min_exponent(x, min_exp), -hi, hi)
    tiny = math.ldexp(1.0, _NORMAL_MIN_EXP)
    return torch.where(y.abs() < tiny, torch.zeros_like(y).copysign(y), y)


def fp16_range_study(a: Tensor,
                     qr_fn: Callable[[Tensor], tuple[Tensor, Tensor]]
                     ) -> dict:
    """QR of ``a`` and of its fp16-range image
    (``clamp_exponent_range(a, -14, 15)``) by ``qr_fn``: orthogonality
    and residual of both, in float64 on ``a``'s device, and the exponent
    histogram of ``a``."""
    q0, r0 = qr_fn(a)
    a16 = clamp_exponent_range(a, -14, 15)
    q1, r1 = qr_fn(a16)
    return {
        "orthogonality": validation.orthogonality_accurate(q0),
        "orthogonality_fp16_range": validation.orthogonality_accurate(q1),
        "residual": validation.residual_accurate(a, q0, r0),
        "residual_fp16_range": validation.residual_accurate(a16, q1, r1),
        "exponent_hist": validation.exponent_distribution(a),
    }
