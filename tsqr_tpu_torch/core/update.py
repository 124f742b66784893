"""QR updating: append or delete rows and columns, and low-rank updates.

Counterpart of ``tsqr_tpu/core/update.py``.  Every update is one SMALL
factorization, on an (n + p, n)-scale core or an (m, p) panel, plus
(m, n)-scale products, never a chain of Givens or hyperbolic rotations:

  qr_append_rows  one TSQR combine node on [R; B] + one (m, n) product.
  qr_append_cols  one BlockQR panel step for the new block: projection,
                  panel QR, and under ``reorth`` the CGS2 second pass with
                  its R fix-ups.
  qr_delete_cols  one (n, n - d) QR re-triangularizes R[:, keep];
                  Q' = Q Q_s.
  qr_delete_rows  the Gram downdate in closed form: Q' = Q2 U^{-1},
                  R' = U R with U = chol(I - W^T W), one (n, n) Cholesky.
  qr_rank_update  A + U V^T: U orthogonalized against Q, then one bordered
                  (n + k, n) QR.

The m-scale products run at the mode's ``trailing_mm`` (plain float32
products for every mode but bf16's); the small cores run through
``blockqr.qr`` in the same mode, so on the card they reach the panel
kernel.  Each function runs on the card unless ``device="cpu"``; the
inputs are moved to its device.  Results are in the mode's IO dtype, R
upper triangular.  Gradients flow through the differentiable
``blockqr.qr`` (``core/diff.py``) and plain torch ops; the update
functions themselves carry no rule of their own.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr, cholqr
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def _small_qr(x: Tensor, policy: modes.Policy) -> tuple[Tensor, Tensor]:
    """Library QR of an update core: BlockQR over the Householder tree,
    unconditionally stable (a core such as [R; B] is as ill-conditioned
    as the updated matrix itself)."""
    return blockqr.qr(x, policy, device=x.device)


def _check_thin(m: int, n: int, what: str) -> None:
    if n > m:
        raise ValueError(f"{what} would make the factorization wide: "
                         f"m={m} < n={n}")


def _fp32(policy: modes.Policy) -> modes.Policy:
    """The caller's mode with float32 IO: the update works in float32 and
    casts once at the end, as BlockQR does."""
    return modes.Policy(policy.mode, torch.float32, policy.work_dtype,
                        policy.mm, policy.corrected)


def _place(device, what: str, *xs) -> list[Tensor]:
    dev = _device.resolve(device, what)
    return [torch.as_tensor(x).to(dev) for x in xs]


def _out(policy: modes.Policy, q: Tensor, r: Tensor) -> tuple[Tensor, Tensor]:
    return q.to(policy.io_dtype), torch.triu(r).to(policy.io_dtype)


def qr_append_rows(q: Tensor, r: Tensor, b: Tensor,
                   mode: modes.ComputeMode | str | modes.Policy = "fp32",
                   device=None) -> tuple[Tensor, Tensor]:
    """Update A = Q R to [A; B] = Q' R' for new rows B ((p, n)).

    The QR of the stacked [R; B] ((n + p, n)) gives R' and a small Q_s
    whose top block rotates the old Q: one tree combine, applied
    incrementally, and one (m, n) x (n, n) product."""
    policy = modes.resolve(mode)
    q, r, b = _place(device, "qr_append_rows", q, r, b)
    n, nb = q.shape[1], b.shape[1]
    if nb != n:
        raise ValueError(f"B has {nb} cols, factorization has {n}")
    s = torch.cat([torch.triu(r).to(torch.float32), b.to(torch.float32)])
    qs, r_new = _small_qr(s, _fp32(policy))
    q_new = torch.cat([policy.trailing_mm(q.to(torch.float32), qs[:n]),
                       qs[n:]])
    return _out(policy, q_new, r_new)


def qr_append_cols(q: Tensor, r: Tensor, b: Tensor,
                   mode: modes.ComputeMode | str | modes.Policy = "fp32",
                   reorth: bool = False,
                   device=None) -> tuple[Tensor, Tensor]:
    """Update A = Q R to [A, B] = Q' R' for new columns B ((m, p)).

    One BlockQR panel step for the new block: R12 = Q^T B, the panel QR
    of the projected B, and under ``reorth`` the CGS2 second projection
    with the fix-ups R12 += S2 R22, R22 = W R22."""
    policy = modes.resolve(mode)
    q, r, b = _place(device, "qr_append_cols", q, r, b)
    (m, n), (mb, p) = q.shape, b.shape
    if mb != m:
        raise ValueError(f"B has {mb} rows, factorization has {m}")
    _check_thin(m, n + p, "appending these columns")
    mm = policy.trailing_mm
    q32, b32 = q.to(torch.float32), b.to(torch.float32)
    r12 = mm(q32.T, b32)
    qb, r22 = _small_qr(b32 - mm(q32, r12), _fp32(policy))
    if reorth:
        s2 = mm(q32.T, qb)
        qb, w = _small_qr(qb - mm(q32, s2), _fp32(policy))
        r12 = r12 + mm(s2, r22)
        r22 = mm(w, r22)
    q_new = torch.cat([q32, qb], dim=1)
    r_new = torch.cat([
        torch.cat([torch.triu(r).to(torch.float32), r12], dim=1),
        torch.cat([r22.new_zeros(p, n), torch.triu(r22)], dim=1)])
    return _out(policy, q_new, r_new)


def qr_delete_cols(q: Tensor, r: Tensor, idx: int | Sequence[int],
                   mode: modes.ComputeMode | str | modes.Policy = "fp32",
                   device=None) -> tuple[Tensor, Tensor]:
    """Update A = Q R to A without the columns ``idx`` = Q' R'.

    R[:, keep] is upper Hessenberg in blocks; one small (n, n - d) QR
    re-triangularizes it and its Q_s rotates the old Q in one (m, n)
    product."""
    policy = modes.resolve(mode)
    q, r = _place(device, "qr_delete_cols", q, r)
    n = q.shape[1]
    drop = {int(idx)} if isinstance(idx, int) else {int(i) for i in idx}
    bad = [i for i in drop if not 0 <= i < n]
    if bad:
        raise ValueError(f"column indices {bad} out of range for n={n}")
    keep = [j for j in range(n) if j not in drop]
    if not keep:
        raise ValueError("cannot delete every column")
    rk = torch.triu(r).to(torch.float32)[:, keep]
    qs, r_new = _small_qr(rk, _fp32(policy))
    return _out(policy, policy.trailing_mm(q.to(torch.float32), qs), r_new)


def qr_delete_rows(q: Tensor, r: Tensor, p: int,
                   mode: modes.ComputeMode | str | modes.Policy = "fp32",
                   polish: bool = True,
                   device=None) -> tuple[Tensor, Tensor]:
    """Update A = Q R to A[p:] = Q' R' (drop the FIRST p rows).

    With W = Q[:p] the downdated Gram is A2^T A2 = R^T (I - W^T W) R, so
    U = chol_upper(I - W^T W) gives R' = U R and Q' = Q[p:] U^{-1}: one
    (n, n) Cholesky, a triangular inverse and one (m - p, n) product.  To
    drop other rows, move them to the front first (P A = (P Q) R).

    The downdate is well posed while the kept rows still span: where the
    dropped rows carry nearly all of some direction, I - W^T W is
    singular and the Cholesky gives NaNs rather than a fabricated basis;
    factorize A[p:] afresh there.  ``polish`` (default) runs one
    CholeskyQR pass on Q', so that its orthogonality does not compound
    into later updates."""
    policy = modes.resolve(mode)
    q, r = _place(device, "qr_delete_rows", q, r)
    m, n = q.shape
    if not 0 <= p < m:
        raise ValueError(f"cannot drop {p} of {m} rows")
    _check_thin(m - p, n, f"dropping {p} rows")
    if p == 0:
        return q, r
    q32 = q.to(torch.float32)
    w = q32[:p]
    mm = policy.trailing_mm
    t = torch.eye(n, device=q.device) - modes.mm_fp32(w.T, w)
    u = cholqr._chol_r(t, shift=None)
    q_new = mm(q32[p:], cholqr._rinv(u))
    r_new = modes.mm_fp32(u, torch.triu(r).to(torch.float32))
    if polish:
        u2 = cholqr._chol_r(modes.gram(q_new, _fp32(policy)), shift=None)
        q_new = mm(q_new, cholqr._rinv(u2))
        r_new = modes.mm_fp32(u2, r_new)
    return _out(policy, q_new, r_new)


def qr_rank_update(q: Tensor, r: Tensor, u: Tensor, v: Tensor,
                   mode: modes.ComputeMode | str | modes.Policy = "fp32",
                   device=None) -> tuple[Tensor, Tensor]:
    """Update A = Q R to A + U V^T = Q' R' for U ((m, k)), V ((n, k)).

    U is orthogonalized against Q (one projection and one (m, k) panel
    QR), then the bordered core [[R + C V^T], [R_u V^T]] ((n + k, n)) is
    factored and its Q_s rotates [Q, Q_u] in two (m, .) products.  A
    downdate is ``qr_rank_update(q, r, -u, v)``; the accuracy is that of
    a fresh factorization of A + U V^T."""
    policy = modes.resolve(mode)
    q, r, u, v = _place(device, "qr_rank_update", q, r, u, v)
    (m, n), (mu, k) = q.shape, u.shape
    nv, kv = v.shape
    if mu != m or nv != n or kv != k:
        raise ValueError(f"U {tuple(u.shape)} / V {tuple(v.shape)} do not "
                         f"border a ({m}, {n}) factorization")
    mm = policy.trailing_mm
    q32 = q.to(torch.float32)
    u32, v32 = u.to(torch.float32), v.to(torch.float32)
    c = mm(q32.T, u32)
    qu, ru = _small_qr(u32 - mm(q32, c), _fp32(policy))
    core = torch.cat([torch.triu(r).to(torch.float32) + mm(c, v32.T),
                      mm(ru, v32.T)])
    qs, r_new = _small_qr(core, _fp32(policy))
    return _out(policy, mm(q32, qs[:n]) + mm(qu, qs[n:]), r_new)
