"""Block Lanczos with TSQR orthogonalization (the 'batched TSQR feeding
... block Lanczos' configuration).

Counterpart of ``tsqr_tpu/models/lanczos.py``: each Lanczos block is
orthonormalized by TSQR (the panel kernel's tree on the card), with
optional full reorthogonalization against the basis.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.models._common import no_mesh
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
    ``mesh``: reserved for the distributed route (ROADMAP A.7); it must
    be None."""
    no_mesh(mesh, "block_lanczos")
    dev = _device.resolve(device, "block_lanczos")

    def _orth(x):
        return tsqr_mod.tsqr(x, mode, device=dev, **tsqr_kw)

    q, _ = _orth(_normal(gen, (n, block), dev))
    q = q.to(torch.float32)
    basis = [q]
    alphas, betas = [], []
    q_prev = b_prev = None
    for it in range(iters):
        w = matvec(q)
        alpha = modes.mm_fp32(q.T, w)
        w = w - modes.mm_fp32(q, alpha)
        if q_prev is not None:
            w = w - modes.mm_fp32(q_prev, b_prev.T)
        if full_reorth:
            qs = torch.cat(basis, dim=1)
            w = w - modes.mm_fp32(qs, modes.mm_fp32(qs.T, w))
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
