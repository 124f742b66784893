"""Randomized SVD built on TSQR (the 'batched TSQR feeding randomized
SVD' configuration).

Counterpart of ``tsqr_tpu/models/rsvd.py``.  The range finder's
orthogonalizations are the Householder tree, whose leaves are the panel
kernel on the card.  Under ``mesh=`` they are the distributed ladder
and the two contractions over m are sums over the ranks.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.models._common import psum_rows, svd
from tsqr_tpu_torch.parallel import dtsqr
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
    :func:`tsqr`.  Runs on the card unless ``device="cpu"``.

    ``mesh``: ``a`` is this rank's row shard of a mesh
    (``parallel.mesh``), and every rank's ``gen`` is seeded alike (Omega
    is the same on every rank).  The orthogonalizations run the
    distributed ladder (``dtsqr.dqr_auto``, ``tsqr_kw`` going to it),
    A^T Q and Q^T A are summed over the ranks, and U comes back as this
    rank's rows."""
    a = _device.place(a, device, "rsvd")
    m, n = a.shape
    k = min(rank + oversample, n)
    omega = _normal(gen, (n, k), a.device)

    def _orth(y):
        if mesh is None:
            return tsqr_mod.tsqr(y, mode, device=a.device, **tsqr_kw)[0]
        return dtsqr.dqr_auto(y, mesh, mode, device=a.device, **tsqr_kw)[0]

    def _sum(x):
        return x if mesh is None else psum_rows(x, mesh)

    y = modes.mm_fp32(a, omega)
    q = _orth(y)
    for _ in range(power_iters):
        z = _sum(modes.mm_fp32(a.T, q.to(torch.float32)))
        y = modes.mm_fp32(a, z)
        q = _orth(y)
    b = _sum(modes.mm_fp32(q.to(torch.float32).T, a))      # (k, n)
    ub, s, vt = svd(b)
    u = modes.mm_fp32(q.to(torch.float32), ub)
    return u[:, :rank], s[:rank], vt[:rank]
