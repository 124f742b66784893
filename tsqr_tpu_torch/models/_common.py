"""What the models share: the sums of their mesh routes and the small
SVD."""

from __future__ import annotations

import torch

from tsqr_tpu_torch.parallel import comm
from tsqr_tpu_torch.parallel import mesh as mesh_mod

Tensor = torch.Tensor


def psum_rows(x: Tensor, mesh) -> Tensor:
    """Sum of ``x`` over the ranks of the mesh's row axis: a contraction
    over the sharded m axis (Q^T A, A^T Q, ...) of a model's mesh route,
    which the JAX package leaves to GSPMD."""
    return comm.psum(x, mesh, mesh_mod.row_axes(mesh))


def norm_rows(x: Tensor, mesh, dim=None) -> Tensor:
    """The 2-norm of a row-sharded ``x`` (over ``dim``, or all of it)."""
    sq = torch.sum(x * x) if dim is None else torch.sum(x * x, dim=dim)
    return torch.sqrt(psum_rows(sq, mesh))


def svd(x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Thin SVD of a small matrix, to float32 grade on every device.  On
    the card it runs cuSOLVER's ``gesvd`` in float64 and rounds the
    factors back: in float32, for the R of a uniform (2^16, 128) input on
    an H100 at 700 W (``harness/precision.py``), the default driver left
    U's orthogonality at 1.3e-5 and the singular values 1.9e-5 off, and
    ``gesvd`` at 1.7e-6 and 3.1e-6; in float64, 3.6e-8 and 5.2e-8."""
    if x.is_cuda:
        u, s, vt = torch.linalg.svd(x.double(), full_matrices=False,
                                    driver="gesvd")
        return u.to(x.dtype), s.to(x.dtype), vt.to(x.dtype)
    return torch.linalg.svd(x, full_matrices=False)
