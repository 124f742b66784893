"""Polar decomposition A = U H via QDWH, built on the ladder QR.

Counterpart of ``tsqr_tpu/models/polar.py``: the nearest matrix with
orthonormal columns, by the QR-based dynamically weighted Halley
iteration (QDWH, Nakatsukasa & Higham 2013; <= ~6 iterations for any
kappa float32 resolves).

  1. m-scale   A = Q1 R through the library QR (the predictive ladder by
     default, or any ``fastqr`` method).
  2. n-scale   QDWH on the (n, n) R factor: R = U_r H.  Each iteration is
     one stacked (2n, n) QR or one Cholesky and two triangular solves,
     chosen by the weight on the host (one sync an iteration).
  3. m-scale   U = Q1 U_r, one product; A = (Q1 U_r) H shares H.

The n-scale iterations run in full float32 products; the accuracy is
the QR mode's grade.  Requires full column rank: a singular input comes
back with U a partial isometry, and ``U^T U = I`` fails measurably.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import auto, cholqr
from tsqr_tpu_torch.parallel import dtsqr
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor

# Switch each QDWH step to the Cholesky form once the Halley weight c is
# modest: Z = I + c X^T X then has kappa(Z) <~ 1 + c, Cholesky-safe at
# <= ~100, and two (n, n) triangular solves are cheaper than the stacked
# (2n, n) QR.
_CHOL_SWITCH = 100.0


def _cbrt(x: Tensor) -> Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _qdwh_weights(l: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Dynamically weighted Halley coefficients (a, b, c) for the current
    sigma-min lower bound l, and the updated bound: the map
    x -> x (a + b x^2) / (1 + c x^2) sends [l, 1] into [l', 1] with
    l' -> 1 cubically."""
    l2 = l * l
    dd = _cbrt(4.0 * (1.0 - l2) / (l2 * l2))
    sqd = torch.sqrt(1.0 + dd)
    a = sqd + 0.5 * torch.sqrt(torch.clamp_min(
        8.0 - 4.0 * dd + 8.0 * (2.0 - l2) / (l2 * sqd), 0.0))
    b = (a - 1.0) ** 2 / 4.0
    c = a + b - 1.0
    l_new = l * (a + b * l2) / (1.0 + c * l2)
    return a, b, c, l_new


def _qdwh_square(x: Tensor, l0: Tensor, max_iter: int) -> Tensor:
    """QDWH orthogonal factor of a square (n, n) X with sigma_max <= 1
    and sigma_min >= l0 (a lower bound; an overestimate only slows
    convergence).  A host loop: each iteration reads (l, c) in one sync,
    runs the QR or the Cholesky step, and stops once 1 - l is a few
    eps."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=x.device)

    def qr_step(x, a, b, c):
        # [sqrt(c) X; I] = [Q1; Q2] R  =>  X' = (b/c) X
        #                 + (a - b/c)/sqrt(c) * Q1 Q2^T
        sc = torch.sqrt(c)
        q, _ = torch.linalg.qr(torch.cat([sc * x, eye]))
        return (b / c) * x + ((a - b / c) / sc) * modes.mm_fp32(
            q[:n], q[n:].T)

    def chol_step(x, a, b, c):
        # X' = (b/c) X + (a - b/c) X Z^{-1},  Z = I + c X^T X = W W^T
        g = modes.mm_fp32(x.T, x)
        w = torch.linalg.cholesky(eye + c * 0.5 * (g + g.T))
        t = torch.linalg.solve_triangular(w, x.T, upper=False)
        t = torch.linalg.solve_triangular(w.T, t, upper=True)
        return (b / c) * x + (a - b / c) * t.T

    l = l0.to(torch.float32)
    for _ in range(max_iter):
        a, b, c, l_new = _qdwh_weights(l)
        l_h, c_h = torch.stack([l, c]).tolist()
        # l -> 1 cubically; once 1 - l is a few eps the iterate is
        # orthogonal to working precision
        if not abs(1.0 - l_h) > 5e-7:
            break
        x = qr_step(x, a, b, c) if c_h > _CHOL_SWITCH else chol_step(
            x, a, b, c)
        l = l_new
    # one Newton-Schulz polish: with ||X^T X - I|| << 1 after QDWH this
    # pushes orthogonality to the float32 floor
    g = modes.mm_fp32(x.T, x)
    return 1.5 * x - 0.5 * modes.mm_fp32(x, 0.5 * (g + g.T))


def _sigma_bounds(r: Tensor) -> tuple[Tensor, Tensor]:
    """(alpha, l0): alpha >= sigma_max(R) by the Frobenius norm, and
    l0 <= sigma_min(R / alpha) by 1 / ||X^{-1}||_F through two triangular
    solves."""
    r32 = r.to(torch.float32)
    alpha = torch.clamp_min(torch.linalg.norm(r32),
                            torch.finfo(torch.float32).tiny)
    x = r32 / alpha
    eye = torch.eye(r.shape[0], dtype=torch.float32, device=r.device)
    inv_norm = torch.linalg.norm(
        torch.linalg.solve_triangular(x, eye, upper=True))
    l0 = torch.where(torch.isfinite(inv_norm), 1.0 / inv_norm, 0.0)
    # a zero or overflowed estimate (singular R) must not NaN the
    # weights; 1e-8 is below anything float32 resolves anyway
    return alpha, torch.clamp(l0, 1e-8, 0.99)


def polar(a: Tensor, mode="fp32", method: str = "auto", mesh=None,
          max_iter: int = 16, device=None, **qr_kw) -> tuple[Tensor, Tensor]:
    """Polar decomposition of a tall (m, n), m >= n: returns (U (m, n),
    H (n, n)) with A = U H, U^T U = I, H symmetric PSD.

    ``method``: "auto" runs the m-scale QR through the predictive ladder
    (``qr_auto_fused``, ``qr_kw`` going to it); any other string is a
    ``fastqr`` method (e.g. "cholqr3").  Runs on the card unless
    ``device="cpu"``.

    ``mesh``: ``a`` is this rank's row shard (``parallel.mesh``); the QR
    runs the distributed ladder (``dtsqr.dqr_auto``, ``qr_kw`` going to
    it, ``method`` unused), QDWH and U = Q1 U_r stay local, U comes back
    as this rank's rows and H the same on every rank."""
    a = _device.place(a, device, "polar")
    m, n = a.shape
    if mesh is not None:
        q1, r = dtsqr.dqr_auto(a, mesh, mode, device=a.device, **qr_kw)
    elif m < n:
        raise ValueError(f"polar requires m >= n, got {tuple(a.shape)}")
    elif method == "auto":
        q1, r = auto.qr_auto_fused(a, mode, device=a.device, **qr_kw)
    else:
        q1, r = cholqr.fastqr(a, mode, method=method, device=a.device,
                              **qr_kw)
    alpha, l0 = _sigma_bounds(r)
    r32 = r.to(torch.float32)
    ur = _qdwh_square(r32 / alpha, l0, max_iter)
    # R = U_r H  =>  H = U_r^T R (symmetrized against iteration noise)
    h = modes.mm_fp32(ur.T, r32)
    h = 0.5 * (h + h.T)
    return modes.mm_fp32(q1.to(torch.float32), ur), h


def procrustes(a: Tensor, b: Tensor, device=None) -> Tensor:
    """Orthogonal Procrustes: the (n, n) orthogonal Omega minimizing
    ||A Omega - B||_F, the polar factor of A^T B.  The m-scale work is
    the one full-float32 product A^T B; QDWH runs on the (n, n) product.
    Requires A^T B numerically full rank (otherwise Omega comes back a
    partial isometry in the noise subspace, the objective still
    minimized).  Runs on the card unless ``device="cpu"``."""
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"procrustes needs matching shapes, got "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    a = _device.place(a, device, "procrustes")
    b = _device.place(b, a.device, "procrustes")
    mtx = modes.mm_fp32(a.T, b)
    alpha, l0 = _sigma_bounds_dense(mtx)
    return _qdwh_square(mtx / alpha, l0, 16)


def _sigma_bounds_dense(mtx: Tensor) -> tuple[Tensor, Tensor]:
    """(alpha, l0) of a dense square matrix: triangularize first (one
    small QR) so that :func:`_sigma_bounds` applies; sigma(R) =
    sigma(M)."""
    return _sigma_bounds(torch.linalg.qr(mtx.to(torch.float32)).R)
