"""Randomized SVD built on TSQR (the 'batched TSQR feeding randomized
SVD' configuration).

Counterpart of ``tsqr_tpu/models/rsvd.py``.  The range finder's
orthogonalizations are the Householder tree, whose leaves are the panel
kernel on the card.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.models._common import no_mesh, svd
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def _normal(gen: torch.Generator, shape, device) -> Tensor:
    """Standard normal float32 draw from ``gen``, a generator on
    ``device``: the module's only source of randomness."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def rsvd(a: Tensor, rank: int, gen: torch.Generator, mode="fp32",
         oversample: int = 8, power_iters: int = 1, mesh=None, device=None,
         **tsqr_kw) -> tuple[Tensor, Tensor, Tensor]:
    """Randomized truncated SVD: A (m, n) ~= U diag(s) V^T at the given
    rank.

    The tall sketch Y = A Omega (Omega (n, rank + oversample) Gaussian
    from ``gen``, a ``torch.Generator``) is orthogonalized by TSQR, and
    so is every power iteration (Halko et al.); ``tsqr_kw`` go to
    :func:`tsqr`.  Runs on the card unless ``device="cpu"``.  ``mesh``:
    reserved for the distributed route (ROADMAP A.7); it must be None."""
    no_mesh(mesh, "rsvd")
    a = _device.place(a, device, "rsvd")
    m, n = a.shape
    k = min(rank + oversample, n)
    omega = _normal(gen, (n, k), a.device)

    def _orth(y):
        return tsqr_mod.tsqr(y, mode, device=a.device, **tsqr_kw)[0]

    y = modes.mm_fp32(a, omega)
    q = _orth(y)
    for _ in range(power_iters):
        z = modes.mm_fp32(a.T, q.to(torch.float32))
        y = modes.mm_fp32(a, z)
        q = _orth(y)
    b = modes.mm_fp32(q.to(torch.float32).T, a)      # (k, n)
    ub, s, vt = svd(b)
    u = modes.mm_fp32(q.to(torch.float32), ub)
    return u[:, :rank], s[:rank], vt[:rank]
