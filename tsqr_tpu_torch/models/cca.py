"""Canonical correlation analysis via tall-skinny QR (Björck–Golub).

Counterpart of ``tsqr_tpu/models/cca.py``: orthonormalize X and Y
independently (the m-scale work), then take the thin SVD of the small
(p, q) product Qx^T Qy; its singular values are the canonical
correlations, and the weights come back through the R factors.  Working
from Qx^T Qy instead of the covariance-whitening normal equations does
not square kappa(X), so the result degrades directly with the QR's own
||Q^T Q - I||.  Under ``mesh=`` both QRs run the distributed ladder and
Qx^T Qy is summed over the ranks.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import auto, cholqr
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.models._common import psum_rows, svd
from tsqr_tpu_torch.parallel import comm, dtsqr
from tsqr_tpu_torch.parallel import mesh as mesh_mod
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor

# the QR routes of ``method``: the Householder tree, the predictive
# ladder, or any fastqr method
_ROUTES = ("tsqr", "auto") + tuple(cholqr._METHODS)


def cca(x: Tensor, y: Tensor, rank: int | None = None, mode="fp32",
        center: bool = False, mesh=None, method: str = "tsqr", device=None,
        **qr_kw) -> tuple[Tensor, Tensor, Tensor]:
    """Canonical correlations of two tall design matrices.

    Args:
      x: (m, p) observations by features, m >= p.
      y: (m, q) second view, same m, m >= q.
      rank: number of canonical pairs r (default min(p, q)).
      mode: precision policy of the two m-scale orthogonalizations (the
        small SVD and solves run float32).
      center: subtract the column means first (statistical CCA).
      mesh: ``x`` and ``y`` are this rank's rows over a mesh
        (``parallel.mesh``): both QRs run the distributed ladder
        (``dtsqr.dqr_auto``, ``qr_kw`` going to it, ``method``
        unused), the means and Qx^T Qy are sums over the ranks, and the
        results are the same on every rank.
      method: the QR of each view: "tsqr" (the Householder tree; the
        panel kernel on the card), "auto" (the predictive ladder,
        ``qr_auto_fused``; the stream kernel) or any ``fastqr`` method
        (e.g. "cholqr2").  Checked before any work; ``qr_kw`` go to the
        chosen QR.
      device: the card unless ``device="cpu"``.

    Returns (corrs, wx, wy): correlations (r,) in [0, 1] descending and
    weights (p, r), (q, r); the variates X wx and Y wy have unit-norm
    columns with U^T V = diag(corrs).  Differentiable in ``x`` and ``y``
    through the QRs' entry rule.  The weights back-solve through R and
    inherit its conditioning: reduce numerically rank-deficient views
    first."""
    if method not in _ROUTES:
        raise ValueError(f"cca: unknown method {method!r}; expected 'tsqr', "
                         f"'auto' or a fastqr method {sorted(cholqr._METHODS)}")
    x = _device.place(x, device, "cca")
    y = _device.place(y, x.device, "cca")
    m, p = x.shape
    m2, q = y.shape
    if m2 != m:
        raise ValueError(f"x and y must share the observation axis: "
                         f"{m} vs {m2}")
    r = min(p, q) if rank is None else min(rank, p, q)
    if center and mesh is None:
        x = x - torch.mean(x, dim=0, keepdim=True)
        y = y - torch.mean(y, dim=0, keepdim=True)
    elif center:
        m_glob = m * comm.axes_size(mesh, mesh_mod.row_axes(mesh))
        x = x - psum_rows(torch.sum(x, dim=0, keepdim=True), mesh) / m_glob
        y = y - psum_rows(torch.sum(y, dim=0, keepdim=True), mesh) / m_glob

    dev = x.device
    if mesh is not None:
        qx, rx = dtsqr.dqr_auto(x, mesh, mode, device=dev, **qr_kw)
        qy, ry = dtsqr.dqr_auto(y, mesh, mode, device=dev, **qr_kw)
    elif method == "tsqr":
        qx, rx = tsqr_mod.tsqr(x, mode, device=dev, **qr_kw)
        qy, ry = tsqr_mod.tsqr(y, mode, device=dev, **qr_kw)
    elif method == "auto":
        qx, rx = auto.qr_auto_fused(x, mode, device=dev, **qr_kw)
        qy, ry = auto.qr_auto_fused(y, mode, device=dev, **qr_kw)
    else:
        qx, rx = cholqr.fastqr(x, mode, method=method, device=dev, **qr_kw)
        qy, ry = cholqr.fastqr(y, mode, method=method, device=dev, **qr_kw)

    c = modes.mm_fp32(qx.to(torch.float32).T, qy.to(torch.float32))
    if mesh is not None:
        c = psum_rows(c, mesh)
    u, s, vt = svd(c)
    corrs = torch.clamp(s[:r], 0.0, 1.0)
    wx = torch.linalg.solve_triangular(rx.to(torch.float32), u[:, :r],
                                       upper=True)
    wy = torch.linalg.solve_triangular(ry.to(torch.float32), vt[:r].T,
                                       upper=True)
    return corrs, wx, wy
