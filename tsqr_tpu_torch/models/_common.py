"""What the models share: the reserved ``mesh=`` parameter and the small
SVD."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def no_mesh(mesh, what: str) -> None:
    """Raise for a ``mesh`` other than None: the models' multi-card
    routes run over ``parallel/`` on ``torch.distributed``, which the
    port does not have yet (ROADMAP A.7)."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...): the distributed routes wait for the port "
            "of parallel/ (ROADMAP A.7); call it with mesh=None")


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
