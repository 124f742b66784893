"""Spectral consumers of the QR stack: subspace iteration and Nystrom.

Counterpart of ``tsqr_tpu/models/subspace.py``.  Both take
``matvec: X (n, b) -> A @ X`` (the operator is never materialized) and
orthogonalize through the predictive ladder (``qr_auto_fused``: the
stream kernel on the card for b <= 128):

  * :func:`subspace_iteration`: top-k eigenpairs of a symmetric operator
    by orthogonal iteration and a Rayleigh-Ritz rotation;
  * :func:`nystrom`: one-shot randomized Nystrom approximation of a PSD
    operator (Tropp et al. 2017, shifted and whitened), its thin SVD
    through the library QR.

Under ``mesh=`` the block is row-sharded, ``matvec`` takes and returns
this rank's rows, the QRs run the distributed ladder
(``dtsqr.dqr_auto``) and the small contractions over n are sums over
the ranks.  The Gaussian starts are drawn whole on every rank from the
same seeded ``gen`` and sliced, so a mesh route equals the local one up
to summation order.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import auto
from tsqr_tpu_torch.models._common import norm_rows, psum_rows, svd
from tsqr_tpu_torch.parallel import dtsqr
from tsqr_tpu_torch.parallel import mesh as mesh_mod
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def _normal(gen: torch.Generator, shape, device) -> Tensor:
    """Standard normal float32 draw from ``gen``, a generator on
    ``device``: the module's only source of randomness."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def _orth(mode, dev, mesh, qr_kw):
    if mesh is None:
        return lambda y: auto.qr_auto_fused(y, mode, device=dev, **qr_kw)
    return lambda y: dtsqr.dqr_auto(y, mesh, mode, device=dev, **qr_kw)


def _start(gen: torch.Generator, shape, dev, mesh) -> Tensor:
    """The Gaussian start, whole, then this rank's rows under a mesh."""
    x = _normal(gen, shape, dev)
    return x if mesh is None else mesh_mod.row_shard(x, mesh)


def subspace_iteration(matvec, n: int, k: int, gen: torch.Generator,
                       iters: int = 20, mode="fp32", oversample: int = 4,
                       mesh=None, return_resid: bool = False, device=None,
                       **qr_kw):
    """Top-k eigenpairs of a symmetric operator by orthogonal iteration.

    Args:
      matvec: X (n, b) -> A @ X for symmetric A (n, n), on the call's
        device.
      n: operator dimension; k: wanted eigenpairs; iters: iterations.
      gen: ``torch.Generator`` of the start block.
      oversample: extra basis columns (converge the tail, then crop).
    Returns ``(w, v)``: eigenvalues (k,) descending by |w| and
    eigenvectors (n, k), plus the per-pair residual norms
    ``||A v - w v||`` (k,) when ``return_resid``.  Pair i converges at
    rate |lambda_{b+1} / lambda_i| an iteration (b = k + oversample);
    each iteration is one apply and one ladder QR.  Runs on the card
    unless ``device="cpu"``; ``qr_kw`` go to :func:`qr_auto_fused`.
    ``mesh``: the module docstring's mesh route; v comes back as this
    rank's rows."""
    dev = _device.resolve(device, "subspace_iteration")
    b = min(k + oversample, n)
    orth = _orth(mode, dev, mesh, qr_kw)

    q = orth(_start(gen, (n, b), dev, mesh))[0].to(torch.float32)
    for _ in range(iters):
        q = orth(matvec(q))[0].to(torch.float32)

    # Rayleigh-Ritz: T = Q^T A Q (symmetrized against apply noise)
    aq = matvec(q)
    t = modes.mm_fp32(q.T, aq)
    if mesh is not None:
        t = psum_rows(t, mesh)
    w_all, s = torch.linalg.eigh(0.5 * (t + t.T))          # ascending
    order = torch.argsort(-torch.abs(w_all), stable=True)[:k]
    w = w_all[order]
    v = modes.mm_fp32(q, s[:, order])
    if not return_resid:
        return w, v
    av = modes.mm_fp32(aq, s[:, order])
    if mesh is None:
        return w, v, torch.linalg.norm(av - v * w[None, :], dim=0)
    return w, v, norm_rows(av - v * w[None, :], mesh, dim=0)


def nystrom(matvec, n: int, rank: int, gen: torch.Generator, mode="fp32",
            oversample: int = 8, mesh=None, device=None,
            **qr_kw) -> tuple[Tensor, Tensor]:
    """Randomized Nystrom approximation of a PSD operator:
    A ~= U diag(lam) U^T at the given rank, from one sketch apply.

    With an orthonormal test matrix Omega (n, l) (the ladder QR of a
    Gaussian from ``gen``), Y = A Omega and the shift nu = eps ||Y||:
    B = (Y + nu Omega) chol(Omega^T Y + nu I)^{-T}, B = U S W^T (the thin
    SVD through the library QR), lam = max(S^2 - nu, 0).  Requires PSD A.
    Returns ``(u (n, rank), lam (rank,))`` with lam descending >= 0.
    Runs on the card unless ``device="cpu"``; ``qr_kw`` go to
    :func:`qr_auto_fused`.  ``mesh``: the module docstring's mesh route;
    u comes back as this rank's rows."""
    dev = _device.resolve(device, "nystrom")
    l = min(rank + oversample, n)
    orth = _orth(mode, dev, mesh, qr_kw)

    omega = orth(_start(gen, (n, l), dev, mesh))[0].to(torch.float32)
    y = matvec(omega).to(torch.float32)
    ynorm = torch.linalg.norm(y) if mesh is None else norm_rows(y, mesh)
    nu = torch.finfo(torch.float32).eps * ynorm
    y = y + nu * omega
    c = modes.mm_fp32(omega.T, y)                      # Omega^T Y + nu I
    if mesh is not None:
        c = psum_rows(c, mesh)
    w = torch.linalg.cholesky(0.5 * (c + c.T))
    b = torch.linalg.solve_triangular(w, y.T, upper=False).T
    # thin SVD of the tall (n, l) B through the library QR
    qb, rb = orth(b)[:2]
    us, s, _ = svd(rb.to(torch.float32))
    u = modes.mm_fp32(qb.to(torch.float32), us[:, :rank])
    return u, torch.clamp_min(s[:rank] ** 2 - nu, 0.0)
