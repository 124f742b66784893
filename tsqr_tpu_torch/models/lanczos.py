"""Block Lanczos with TSQR orthogonalization (the 'batched TSQR feeding
... block Lanczos' configuration).

Counterpart of ``tsqr_tpu/models/lanczos.py``: each Lanczos block is
orthonormalized by TSQR (the panel kernel's tree on the card), with
optional full reorthogonalization against the basis.  Under ``mesh=``
the basis is row-sharded, the blocks are orthonormalized by the
distributed ladder and the projections are sums over the ranks.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.models._common import psum_rows
from tsqr_tpu_torch.parallel import dtsqr
from tsqr_tpu_torch.parallel import mesh as mesh_mod
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def _normal(gen: torch.Generator, shape, device) -> Tensor:
    """Standard normal float32 draw from ``gen``, a generator on
    ``device``: the module's only source of randomness."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def block_lanczos(matvec, n: int, block: int, iters: int,
                  gen: torch.Generator, mode="fp32",
                  full_reorth: bool = True, mesh=None, device=None,
                  **tsqr_kw) -> tuple[Tensor, Tensor, Tensor]:
    """Block Lanczos tridiagonalization of a symmetric operator.

    Args:
      matvec: function X (n, b) -> A @ X, on the call's device.
      n: operator dimension; block: block size; iters: Lanczos steps.
      gen: ``torch.Generator`` of the start block.
    Returns (basis Q (n, block*iters), alphas (iters, b, b),
    betas (iters-1, b, b)) with Q^T A Q block-tridiagonal.  Runs on the
    card unless ``device="cpu"``; ``tsqr_kw`` go to :func:`tsqr`.

    ``mesh``: run over a mesh (``parallel.mesh``): the basis is
    row-sharded, ``matvec`` takes and returns this rank's rows, and Q
    comes back as this rank's rows.  The start block is drawn whole from
    ``gen`` (seeded alike on every rank) and sliced, so the route equals
    the local one up to summation order; the orthogonalizations run the
    distributed ladder (``dtsqr.dqr_auto``, ``tsqr_kw`` going to it)."""
    dev = _device.resolve(device, "block_lanczos")

    def _orth(x):
        if mesh is None:
            return tsqr_mod.tsqr(x, mode, device=dev, **tsqr_kw)
        return dtsqr.dqr_auto(x, mesh, mode, device=dev, **tsqr_kw)

    def _sum(x):
        return x if mesh is None else psum_rows(x, mesh)

    v0 = _normal(gen, (n, block), dev)
    if mesh is not None:
        v0 = mesh_mod.row_shard(v0, mesh)
    q, _ = _orth(v0)
    q = q.to(torch.float32)
    basis = [q]
    alphas, betas = [], []
    q_prev = b_prev = None
    for it in range(iters):
        w = matvec(q)
        alpha = _sum(modes.mm_fp32(q.T, w))
        w = w - modes.mm_fp32(q, alpha)
        if q_prev is not None:
            w = w - modes.mm_fp32(q_prev, b_prev.T)
        if full_reorth:
            qs = torch.cat(basis, dim=1)
            w = w - modes.mm_fp32(qs, _sum(modes.mm_fp32(qs.T, w)))
        alphas.append(alpha)
        if it + 1 == iters:
            break
        q_next, beta = _orth(w)
        betas.append(beta.to(torch.float32))
        q_prev, b_prev = q, betas[-1]
        q = q_next.to(torch.float32)
        basis.append(q)
    return (torch.cat(basis, dim=1), torch.stack(alphas),
            torch.stack(betas) if betas
            else torch.zeros(0, block, block, device=dev))
