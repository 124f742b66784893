"""Randomized column-pivoted (rank-revealing) QR, and the interpolative and
CUR skeletons from the same sketch machinery.

Counterpart of ``tsqr_tpu/models/qrcp.py`` (Duersch & Gu): the pivots
come from a Gaussian sketch B = Omega A, so the m-scale work is one
product and one tall QR through the predictive ladder
(``qr_auto_fused``: the stream kernel on the card, and the panel
kernel's trees at tier 4 for rank-deficient input).

  1. sketch  B = Omega A, Omega (l, m) Gaussian, l = n + oversample;
  2. pivot   column-pivoted Householder QR of the small (l, n) B, one
     eager step a column (only the permutation and B's rank-revealing
     diagonal are kept);
  3. factor  A[:, piv] through the ladder.

Sketch pivoting is probabilistic: with l = n + p the sketch preserves
column-subset conditioning up to small factors w.h.p.; ``diag_b``
exposes the sketch's R diagonal for rank thresholding.

Under ``mesh=`` A is row-sharded: the column sketch is the distributed
``dtsqr.dsketch`` (one (l, n) all-reduce), the tall QRs run the
distributed ladder, and the pivoting and coefficient solves are the same
small work on every rank.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import auto, cholqr
from tsqr_tpu_torch.models._common import psum_rows
from tsqr_tpu_torch.parallel import comm, dtsqr
from tsqr_tpu_torch.parallel import mesh as mesh_mod
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def _sketch(a: Tensor, gen: torch.Generator, l: int) -> Tensor:
    """B = Omega A, Omega an (l, m) Gaussian drawn chunk by chunk from
    ``gen``, a generator on A's device (``cholqr.sketch_gaussian``): the
    module's only source of randomness."""
    return cholqr.sketch_gaussian(a, gen, l)


def _col_sketch(a: Tensor, gen: torch.Generator, l: int, mesh) -> Tensor:
    """B = Omega A: :func:`_sketch`, or under ``mesh`` the distributed
    sketch of the row shards (``dtsqr.dsketch`` through
    ``cholqr.sketch_gaussian``), the same on every rank whose ``gen`` is
    seeded alike."""
    if mesh is None:
        return _sketch(a, gen, l)
    return cholqr.sketch_gaussian(a, gen, l, mesh=mesh)


def _ranks(mesh) -> int:
    """The ranks over which the mesh's rows are sharded."""
    return comm.axes_size(mesh, mesh_mod.row_axes(mesh))


def _qrcp_small(b: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Column-pivoted Householder QR of a small (l, n) matrix.

    Returns (piv (n,) int64, rdiag (min(l, n),) float32, r (l, n)
    float32): the pivot order, |diag R| (non-increasing: the
    rank-revealing signal) and the triangularized R, with
    B[:, piv] = Q_s R.  Q is never formed.  One eager step a column:
    the argmax of the trailing column norms (read on the host; the first
    maximum, as ``jnp.argmax`` takes), one column swap, one Householder
    reflection applied full-width with full float32 products.  Every
    step is out of place, so the result is differentiable in ``b``."""
    l, n = b.shape
    r = b.to(torch.float32)
    dev = r.device
    rows = torch.arange(l, device=dev)
    cols = torch.arange(n, device=dev)
    piv = cols.clone()
    for k in range(min(l, n)):
        below = (rows >= k)[:, None]
        tail = torch.where(below, r, 0.0)
        norms = torch.where(cols >= k, torch.sum(tail * tail, dim=0),
                            -torch.inf)
        p = int(torch.argmax(norms))
        if p != k:
            idx = cols.clone()
            idx[k], idx[p] = p, k
            r = r[:, idx]
            piv = piv[idx]
        x = torch.where(rows >= k, r[:, k], 0.0)
        sigma = torch.sqrt(torch.sum(x * x))
        xk = x[k]
        alpha = -torch.sign(torch.where(xk == 0, 1.0, xk)) * sigma
        v = torch.where(rows == k, x - alpha, x)
        vtv = torch.sum(v * v)
        beta = torch.where(vtv > 0, 2.0 / torch.where(vtv > 0, vtv, 1.0), 0.0)
        w = modes.mm_fp32(v[None, :], r)[0]
        r = r - beta * v[:, None] * w[None, :]
        # pin column k exactly: the reflection maps it to alpha e_k
        col = torch.where(rows == k, alpha,
                          torch.where(rows > k, 0.0, r[:, k]))
        r = torch.where((cols == k)[None, :], col[:, None], r)
    return piv, torch.abs(torch.diagonal(r[:n, :n])), r


def pivoted_qr(a: Tensor, gen: torch.Generator, mode="fp32",
               oversample: int = 8, mesh=None, device=None,
               **qr_kw) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Rank-revealing QR: A[:, piv] = Q R with |diag| non-increasing.

    Returns (Q (m, n), R (n, n), piv (n,) int64, diag_b (n,)): ``piv``
    the column permutation (apply as ``a[:, piv]``), ``diag_b`` the
    sketch's rank-revealing |R| diagonal (a numerical rank is
    ``int((diag_b > tol * diag_b[0]).sum())``).  ``gen``: a
    ``torch.Generator`` for the sketch; ``qr_kw`` go to
    :func:`qr_auto_fused`.  Runs on the card unless ``device="cpu"``;
    differentiable in ``a`` through the gather and the ladder's entry
    rule (piv is locally constant).

    ``mesh``: ``a`` is this rank's row shard (``parallel.mesh``) and
    ``gen`` is seeded alike on every rank; the sketch is
    ``dtsqr.dsketch``, the QR the distributed ladder
    (``dtsqr.dqr_auto``, ``qr_kw`` going to it), and Q comes back as
    this rank's rows."""
    a = _device.place(a, device, "pivoted_qr")
    m, n = a.shape
    m_glob = m if mesh is None else m * _ranks(mesh)
    if m_glob < n:
        raise ValueError(f"pivoted_qr requires m >= n, got {(m_glob, n)}")
    l = min(m_glob, n + oversample)
    piv, diag_b, _ = _qrcp_small(_col_sketch(a, gen, l, mesh))
    if mesh is None:
        q, r = auto.qr_auto_fused(a[:, piv], mode, device=a.device, **qr_kw)
    else:
        q, r = dtsqr.dqr_auto(a[:, piv], mesh, mode, device=a.device,
                              **qr_kw)
    return q, r, piv, diag_b


def interpolative(a: Tensor, gen: torch.Generator, k: int,
                  oversample: int = 8, mesh=None,
                  device=None) -> tuple[Tensor, Tensor, Tensor]:
    """Column interpolative decomposition: A ~= A[:, cols] @ coeff.

    Sketch only: the pivots and the coefficient both come from the
    column-pivoted QR of B = Omega A (l = k + oversample rows), so the
    only m-scale work is one sketch product.  B[:, piv] = Q_s R_s gives
    T = R_s[:k, :k]^{-1} R_s[:k, :].

    Returns (cols (k,) int64, coeff (k, n) float32, diag_b (l,)):
    ``a[:, cols] @ coeff`` approximates A in the original column order,
    ``coeff[:, cols] == I_k``, and ``diag_b`` shows whether k was large
    enough (a sharp drop before index k means rank(A) < k).  Runs on
    the card unless ``device="cpu"``.

    ``mesh``: ``a`` is this rank's row shard and ``gen`` is seeded alike
    on every rank; the one m-scale product is ``dtsqr.dsketch`` (one
    (l, n) all-reduce) and the results are the same on every rank."""
    a = _device.place(a, device, "interpolative")
    m, n = a.shape
    if mesh is not None:
        m *= _ranks(mesh)
    if not 1 <= k <= min(m, n):
        raise ValueError(f"interpolative: need 1 <= k <= min{(m, n)}"
                         f", got k={k}")
    l = min(m, min(n, k + oversample))
    piv, diag_b, r_s = _qrcp_small(_col_sketch(a, gen, l, mesh))
    # T in pivot order: columns :k are exactly I_k (R11^{-1} R11)
    t = torch.linalg.solve_triangular(r_s[:k, :k], r_s[:k, :], upper=True)
    inv = torch.argsort(piv)            # back to the original column order
    return piv[:k], t[:, inv], diag_b


def cur(a: Tensor, gen: torch.Generator, k: int, mode="fp32",
        oversample: int = 8, mesh=None,
        device=None) -> tuple[Tensor, Tensor, Tensor]:
    """CUR decomposition: A ~= A[:, cols] @ u @ A[rows, :].

    cols are the pivots of the column sketch Omega A, rows those of the
    row sketch Omega' A^T (two draws from ``gen``); u = (C^+ A) R_r^+
    through QR: C = Q_c R_c by the ladder (the m-scale tall QR), and
    R_r^+ = Q_r R_rr^{-T} from the small QR of R_r^T.  Returns
    (cols (k,), u (k, k) float32, rows (k,)).  Runs on the card unless
    ``device="cpu"``.

    ``mesh``: ``a`` is this rank's row shard and ``gen`` is seeded alike
    on every rank.  The column sketch is ``dtsqr.dsketch``; the row
    sketch Omega' A^T contracts over the whole n axis, so each rank
    sketches its own columns of it and one all-gather joins them; the
    selected rows A[rows] are summed from the ranks that hold them, C's
    QR runs the distributed ladder and Q_c^T A is summed over the ranks.
    The results are the same on every rank."""
    a = _device.place(a, device, "cur")
    m, n = a.shape
    m_glob = m if mesh is None else m * _ranks(mesh)
    if not 1 <= k <= min(m_glob, n):
        raise ValueError(f"cur: need 1 <= k <= min{(m_glob, n)}, "
                         f"got k={k}")
    l_c = min(m_glob, min(n, k + oversample))
    piv_c, _, _ = _qrcp_small(_col_sketch(a, gen, l_c, mesh))
    l_r = min(n, min(m_glob, k + oversample))
    b_r = _sketch(a.T, gen, l_r)                        # (l_r, m) or shard
    if mesh is not None:
        b_r = comm.all_gather_rows(b_r.T.contiguous(), mesh,
                                   mesh_mod.row_axes(mesh)).T
    piv_r, _, _ = _qrcp_small(b_r)
    cols, rows = piv_c[:k], piv_r[:k]

    a32 = a.to(torch.float32)
    c = a32[:, cols]                                    # (m, k)
    if mesh is None:
        r_rows = a32[rows, :]                           # (k, n)
        # C^+ A = R_c^{-1} Q_c^T A through the ladder (tall, m-scale)
        q_c, r_c = auto.qr_auto_fused(c, mode, device=a.device)
        qta = modes.mm_fp32(q_c.to(torch.float32).T, a32)
    else:
        # the selected rows, each from the rank that holds it (the
        # others add zeros, exactly)
        lo = mesh_mod.shard_index(mesh)[0] * m
        mine = (rows >= lo) & (rows < lo + m)
        r_rows = torch.where(mine[:, None],
                             a32[(rows - lo).clamp(0, m - 1)], 0.0)
        r_rows = psum_rows(r_rows, mesh)
        q_c, r_c = dtsqr.dqr_auto(c, mesh, mode, device=a.device)
        qta = psum_rows(modes.mm_fp32(q_c.to(torch.float32).T, a32), mesh)
    x = torch.linalg.solve_triangular(r_c.to(torch.float32), qta,
                                      upper=True)       # (k, n)
    # R_r^+ = Q_r R_rr^{-T} from the small QR of R_r^T (n, k)
    q_r, r_rr = torch.linalg.qr(r_rows.T)
    y = modes.mm_fp32(x, q_r)                           # (k, k)
    u = torch.linalg.solve_triangular(r_rr, y.T, upper=True).T
    return cols, u, rows
