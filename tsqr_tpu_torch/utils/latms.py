"""Condition-number-controlled random test matrices, made with numpy.

Counterpart of ``tsqr_tpu/utils/latms.py``: A = U diag(s) V^T with U, V
the Q factors of Gaussian matrices.  JAX and torch draw different random
numbers from one seed, so the matrices are made in numpy and handed to
either package.
"""

from __future__ import annotations

import numpy as np


def latms(rng: np.random.Generator, m: int, n: int, s) -> np.ndarray:
    """A (m, n) float32 = U diag(s) V^T with prescribed singular values."""
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.asarray(s, np.float64)[None, :]) @ v.T).astype(
        np.float32)


def get_cond(a) -> float:
    """Condition number s_max / s_min."""
    s = np.linalg.svd(np.asarray(a, np.float64), compute_uv=False)
    return float(s[0] / s[-1])


def rand_matrix_with_cond(seed: int | np.random.Generator, m: int, n: int,
                          cond: float,
                          max_tries: int = 8) -> tuple[np.ndarray, float]:
    """Random (m, n) float32 with measured condition number >= 0.9 cond:
    interior singular values uniform in [cond^-1/2, 1], s_0 = 1 and
    s_{n-1} = 1/cond, drawn again until the float32 matrix measures
    within 10 % of the target."""
    rng = np.random.default_rng(seed)
    target = float(cond)
    for _ in range(max_tries):
        s = np.sort(rng.uniform(target ** -0.5, 1.0, n))[::-1]
        s[0], s[-1] = 1.0, 1.0 / target
        a = latms(rng, m, n, s)
        measured = get_cond(a)
        if measured >= 0.9 * target:
            break
    return a, measured
