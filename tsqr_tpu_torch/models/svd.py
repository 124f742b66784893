"""Deterministic thin SVD via QR (tall-skinny, exact to working precision).

Counterpart of ``tsqr_tpu/models/svd.py``: A = Q R, R = U_r diag(s) V^T
(an (n, n) problem), U = Q U_r.  All m-scale work is the QR plus one
product, so it inherits the QR's speed and the mixed-precision modes.
Under ``mesh=`` the QR is the distributed ladder and the rest is local.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import cholqr
from tsqr_tpu_torch.models._common import svd
from tsqr_tpu_torch.parallel import dtsqr
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def tsqr_svd(a: Tensor, mode="fp32", method: str = "cholqr3", mesh=None,
             device=None) -> tuple[Tensor, Tensor, Tensor]:
    """Thin SVD of a tall-skinny (m, n): returns (U (m, n), s (n,),
    Vt (n, n)) with A = U diag(s) Vt.

    The QR is ``fastqr(method=method)`` (a ``_fused`` method runs the
    stream kernel on the card); the small SVD runs on the (n, n) R
    factor in float32 (``torch.linalg.svd``), so the singular values'
    accuracy is the QR residual's, the mode's grade.  Runs on the card
    unless ``device="cpu"``.

    ``mesh``: ``a`` is this rank's row shard of a mesh
    (``parallel.mesh``); the QR runs the distributed ladder
    (``dtsqr.dqr_auto``), the (n, n) SVD and U = Q U_r stay local, and U
    comes back as this rank's rows."""
    a = _device.place(a, device, "tsqr_svd")
    m, n = a.shape
    if mesh is not None:
        q, r = dtsqr.dqr_auto(a, mesh, mode, device=a.device)
    elif m < n:
        raise ValueError(f"tsqr_svd requires m >= n, got {tuple(a.shape)}")
    else:
        q, r = cholqr.fastqr(a, mode, method=method, device=a.device)
    ur, s, vt = svd(r.to(torch.float32))
    u = modes.mm_fp32(q.to(torch.float32), ur)
    return u, s, vt
