"""Householder panel QR in plain PyTorch: the TSQR tree's inner-node QR
past the panel kernel's width (n > 512) or on request.

Counterpart of ``tsqr_tpu/ops/householder.py``.  Every function takes a
(..., m, n) panel and factors each panel of the leading axes at once (the
reference's ``vmap``).  ``mm`` routes the reflector products through a
mode's matmul, as in the reference; these functions are the tree's
``tree_impl="jnp"`` route (the reference's, and ``tsqr``'s default past
n = 512, where the leaf too is this QR), the root of ``parallel/dtsqr``'s
cross-rank tree and ``ops/panel_qr``'s façade, not the plain version of a
kernel.

Two strategies, as in the reference: ``householder_qr`` (one reflector
at a time, rank-1 updates) and ``blocked_householder_qr`` (compact WY
(Y, T) per column block, block products for the trailing update and
the Q build).
"""

from __future__ import annotations

from typing import Callable

import torch

from tsqr_tpu_torch import modes

Tensor = torch.Tensor
_EPS = 1e-30


def _house_vector(x: Tensor, j: int,
                  eps: float = _EPS) -> tuple[Tensor, Tensor, Tensor]:
    """Householder vector for columns x (..., m), zeroing entries below j.

    Returns (v, beta, alpha) with H = I - beta v v^T, H x = alpha e_j.
    Entries of x above j must already be masked to zero by the caller.
    v = x + sign(x_j) ||x|| e_j with sign(0) = +1, so R_jj =
    -sign(x_j) ||x||; beta = 0 where ||v||^2 <= eps (H = I for a zero
    column)."""
    norm2 = torch.sum(x * x, dim=-1)
    norm = torch.sqrt(norm2)
    xj = x[..., j]
    sign = torch.where(xj >= 0, 1.0, -1.0).to(x.dtype)
    alpha = -sign * norm
    v = x.clone()
    v[..., j] = xj + sign * norm
    # ||v||^2 = ||x||^2 + 2 sign ||x|| x_j + ||x||^2
    vnorm2 = norm2 + 2.0 * sign * norm * xj + norm2
    beta = torch.where(vnorm2 > eps, 2.0 / vnorm2, torch.zeros_like(vnorm2))
    return v, beta, alpha


def _rank1(v: Tensor, beta: Tensor, x: Tensor, mm: Callable) -> Tensor:
    """x - v (beta v^T x), v^T x through ``mm``."""
    w = beta[..., None] * mm(v[..., None, :], x)[..., 0, :]
    return x - v[..., :, None] * w[..., None, :]


def householder_qr(a: Tensor, mm: Callable[[Tensor, Tensor], Tensor]
                   | None = None) -> tuple[Tensor, Tensor]:
    """Thin QR of (..., m, n) panels, m >= n: returns (Q (..., m, n),
    R (..., n, n)), one reflector at a time.  ``mm`` routes v^T A through
    a mode's matmul; None is float32."""
    m, n = a.shape[-2:]
    if m < n:
        raise ValueError(f"panel must be tall: got {tuple(a.shape)}")
    mm = mm or modes.mm_fp32
    r = a.to(torch.float32)
    rows = torch.arange(m, device=r.device)
    vs, betas = [], []
    for j in range(n):
        x = torch.where(rows >= j, r[..., :, j], 0.0)
        v, beta, _ = _house_vector(x, j)
        r = _rank1(v, beta, r, mm)
        vs.append(v)
        betas.append(beta)
    # Q = H_0 H_1 ... H_{n-1} I_{m x n}, applied in reverse order
    q = torch.eye(m, n, dtype=torch.float32, device=r.device).expand(
        *a.shape[:-2], m, n)
    for j in reversed(range(n)):
        q = _rank1(vs[j], betas[j], q, mm)
    return q, torch.triu(r[..., :n, :])


def _panel_reflectors(a: Tensor, nb: int, col0: int, rows: Tensor,
                      mm: Callable) -> tuple[Tensor, Tensor, Tensor]:
    """Factor columns [col0, col0 + nb) of panels ``a`` (already updated):
    returns (Y (..., m, nb), T (..., nb, nb) upper-triangular compact WY,
    the factored block (..., m, nb))."""
    lead = a.shape[:-2]
    m = a.shape[-2]
    ablk = a[..., :, col0:col0 + nb]
    ys = a.new_zeros(*lead, nb, m)
    ts = a.new_zeros(*lead, nb, nb)
    kidx = torch.arange(nb, device=a.device)
    for k in range(nb):
        j = col0 + k
        x = torch.where(rows >= j, ablk[..., :, k], 0.0)
        v, beta, _ = _house_vector(x, j)
        ablk = _rank1(v, beta, ablk, mm)
        # T_k = [[T, -beta T (Y^T v)], [0, beta]] (Schreiber-Van Loan)
        ytv = mm(ys, v[..., :, None])[..., :, 0]
        tcol = -beta[..., None] * mm(ts, ytv[..., :, None])[..., :, 0]
        ts[..., :, k] = torch.where(kidx < k, tcol, 0.0)
        ts[..., k, k] = beta
        ys[..., k, :] = v
    return ys.transpose(-2, -1), ts, ablk


def blocked_householder_qr(a: Tensor, mm: Callable[[Tensor, Tensor], Tensor]
                           | None = None,
                           block: int = 8) -> tuple[Tensor, Tensor]:
    """Compact-WY blocked Householder QR of (..., m, n) panels: the
    trailing update A -= Y (T^T (Y^T A)) and the Q build
    Q -= Y (T (Y^T Q)) are block products through ``mm``; only the
    rank-1 work inside a block is per column."""
    m, n = a.shape[-2:]
    if m < n:
        raise ValueError(f"panel must be tall: got {tuple(a.shape)}")
    mm = mm or modes.mm_fp32
    block = min(block, n)
    r = a.to(torch.float32).clone()
    rows = torch.arange(m, device=r.device)
    wy = []
    for col0 in range(0, n, block):
        nb = min(block, n - col0)
        yb, tb, rblk = _panel_reflectors(r, nb, col0, rows, mm)
        r[..., :, col0:col0 + nb] = rblk
        if col0 + nb < n:
            a2 = r[..., :, col0 + nb:]
            w = mm(tb.transpose(-2, -1), mm(yb.transpose(-2, -1), a2))
            r[..., :, col0 + nb:] = a2 - mm(yb, w)
        wy.append((yb, tb))
    # Q = (I - Y_0 T_0 Y_0^T) ... (I - Y_last T_last Y_last^T) I_{m x n}
    q = torch.eye(m, n, dtype=torch.float32, device=r.device).expand(
        *a.shape[:-2], m, n)
    for yb, tb in reversed(wy):
        w = mm(tb, mm(yb.transpose(-2, -1), q))
        q = q - mm(yb, w)
    return q, torch.triu(r[..., :n, :])


def qr_sign_normalize(q: Tensor, r: Tensor) -> tuple[Tensor, Tensor]:
    """Flip signs so diag(R) >= 0 (the canonical form for comparing
    factorizations across modes)."""
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    s = torch.where(d < 0, -1.0, 1.0).to(r.dtype)
    return q * s[..., None, :], r * s[..., :, None]
