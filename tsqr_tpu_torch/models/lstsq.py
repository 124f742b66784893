"""Least squares: min ||Ax - b||_2 by BlockQR, by the matrix-free streamed
QR, and by sketch-preconditioned CGLS.

Counterpart of ``tsqr_tpu/models/lstsq.py``.  ``lstsq`` solves R x =
Q^T b with a triangular solve after ``blockqr.qr`` (the panel kernel's
trees on the card); ``lstsq_regen`` takes the composed factor of
``core.ooc.qr_regen``; ``lstsq_cgls`` runs CGLS with a host loop that
syncs once an iteration.
"""

from __future__ import annotations

import math

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr, ooc
from tsqr_tpu_torch.models._common import psum_rows
from tsqr_tpu_torch.parallel import dtsqr
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def _normal(gen: torch.Generator, shape, device) -> Tensor:
    """Standard normal float32 draw from ``gen``, a generator on
    ``device``: the module's only source of randomness."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def _solve_upper(r: Tensor, b: Tensor, trans: bool = False) -> Tensor:
    """R^{-1} b (or R^{-T} b), R upper triangular."""
    if trans:
        return torch.linalg.solve_triangular(r.mT, b, upper=False)
    return torch.linalg.solve_triangular(r, b, upper=True)


def lstsq(a: Tensor, b: Tensor, mode="fp32", reorth: bool = False,
          mesh=None, ridge: float = 0.0, device=None, **qr_kw) -> Tensor:
    """Solve min ||A x - b|| (+ ridge * ||x||^2): A (m, n) tall, b (m,)
    or (m, k).

    ``ridge > 0`` solves the Tikhonov problem through the same m-scale
    factorization: with A = QR, the stacked system [A; sqrt(ridge) I]
    has the R factor of the small (2n, n) stack [R; sqrt(ridge) I], so
    regularization costs one (2n, n) QR and never forms the normal
    equations.  ``qr_kw`` go to :func:`blockqr.qr`.  Runs on the card
    unless ``device="cpu"``; differentiable in ``a`` (through the QR's
    entry rule) and ``b``.

    ``mesh``: ``a`` and ``b`` are this rank's rows over a mesh
    (``parallel.mesh.row_shard`` / ``vec_shard``); the factorization is
    the distributed BlockQR (``dtsqr.dqr``), Q^T b is summed over the
    ranks, and x comes back whole on every rank."""
    if ridge < 0:
        raise ValueError(f"lstsq: ridge must be >= 0, got {ridge}")
    a = _device.place(a, device, "lstsq")
    b = _device.place(b, a.device, "lstsq")
    if mesh is None:
        q, r = blockqr.qr(a, mode, reorth=reorth, device=a.device, **qr_kw)
    else:
        q, r = dtsqr.dqr(a, mesh, mode, reorth=reorth, device=a.device,
                         **qr_kw)
    q, r = q.to(torch.float32), r.to(torch.float32)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    qtb = modes.mm_fp32(q.T, b.to(torch.float32))
    if mesh is not None:
        qtb = psum_rows(qtb, mesh)
    if ridge > 0:
        n = r.shape[0]
        eye = torch.eye(n, dtype=torch.float32, device=r.device)
        q2, r2 = torch.linalg.qr(torch.cat([r, math.sqrt(ridge) * eye]))
        # rhs of the stacked system: Q2^T [Q^T b; 0] = Q2[:n]^T Q^T b
        x = _solve_upper(r2, modes.mm_fp32(q2[:n].T, qtb))
    else:
        x = _solve_upper(r, qtb)
    return x[:, 0] if squeeze else x


def lstsq_regen(gen_chunk, b: Tensor, m: int, n: int, mode="bf16x6_cor",
                method: str = "cholqr2", chunk_rows: int = 1 << 21,
                device=None) -> tuple[Tensor, dict]:
    """Matrix-free least squares: min ||A x - b|| where A is defined by
    ``gen_chunk(i)`` (``core.ooc.qr_regen``'s generator contract) and
    never materialized; b (m,) or (m, k) and the solve stay on the
    device.

    With Q = A R^{-1} from the streamed QR, x = rinv (rinv^T (A^T b)),
    A^T b accumulated chunk by chunk, then the relative residual
    ||A x - b|| / ||b|| streamed the same way.  Returns (x, info) with
    info = {residual, orthogonality}: the achieved relative residual
    (b's component outside range(A) included) and the QR's streamed
    orthogonality, 0-dim tensors on the device.  Runs on the card
    unless ``device="cpu"``."""
    dev = _device.resolve(device, "lstsq_regen")
    b = _device.place(b, dev, "lstsq_regen")
    if b.shape[0] != m or m % chunk_rows:
        raise ValueError(f"lstsq_regen: b has {b.shape[0]} rows for m={m}, "
                         f"chunk_rows={chunk_rows} must divide m")
    n_chunks = m // chunk_rows
    squeeze = b.ndim == 1
    bm = (b[:, None] if squeeze else b).to(torch.float32)
    k = bm.shape[1]

    _, info = ooc.qr_regen(gen_chunk, m, n, mode, method=method,
                           chunk_rows=chunk_rows, device=dev)
    rinv = info["rinv"]

    def chunk(i):
        return gen_chunk(i).to(device=dev, dtype=torch.float32)

    atb = torch.zeros(n, k, dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        bc = bm[i * chunk_rows:(i + 1) * chunk_rows]
        atb = atb + modes.mm_fp32(chunk(i).T, bc)
    x = modes.mm_fp32(rinv, modes.mm_fp32(rinv.T, atb))
    r2 = torch.zeros((), dtype=torch.float32, device=dev)
    b2 = torch.zeros_like(r2)
    for i in range(n_chunks):
        bc = bm[i * chunk_rows:(i + 1) * chunk_rows]
        d = modes.mm_fp32(chunk(i), x) - bc
        r2 = r2 + torch.sum(d * d)
        b2 = b2 + torch.sum(bc * bc)
    out = x[:, 0] if squeeze else x
    return out, {"residual": torch.sqrt(r2) / torch.sqrt(b2),
                 "orthogonality": info["orthogonality"]}


def lstsq_cgls(matvec, rmatvec, b: Tensor, n: int,
               gen: torch.Generator | None = None,
               r_precond: Tensor | None = None, embed: float = 2.0,
               sketch_cols: int = 32, tol: float = 1e-7,
               max_iters: int = 100, device=None) -> tuple[Tensor, dict]:
    """Matrix-free least squares: min ||A x - b|| where A exists only as
    ``matvec``/``rmatvec``, by CGLS right-preconditioned with the R
    factor of a sketch of the operator (Blendenpik/LSRN): the iteration
    count is kappa-independent w.h.p.

    The sketch B = (A^T G)^T, G an (m, l) Gaussian from ``gen`` (a
    ``torch.Generator``), l = embed n rounded up to a multiple of 8, is
    applied through ``rmatvec`` in ``sketch_cols``-wide blocks, so at
    most m sketch_cols floats of G are live.  Each iteration is one
    matvec, one rmatvec and two (n, k) triangular solves.

    Args:
      matvec: x (n, k) -> A @ x (m, k);  rmatvec: y (m, k) -> A^T @ y.
      b: (m,) or (m, k) right-hand side(s).
      n: operator width.
      gen: generator of the preconditioner sketch; None (and no
        ``r_precond``) runs unpreconditioned CGLS.
      r_precond: a precomputed upper-triangular (n, n) preconditioner;
        overrides ``gen``.
      tol: stop when max over columns of ||Ahat^T r|| / ||Ahat^T b|| <
        tol (the least-squares gradient).  A tol below the float32 floor
        (~eps kappa) is safe: see the safeguard below.
      max_iters: iteration cap.

    Returns (x, info): x (n,) or (n, k); info = {"iters": int,
    "grad_rel": (k,) best per-column relative gradient norms}.  The loop
    is on the host: one sync an iteration reads its exit test.

    Finite-precision safeguard: the triangular solves break the exact
    matvec/rmatvec adjoint pairing by ~eps kappa, and CG iterated past
    its gradient floor amplifies rounding noise geometrically, so the
    loop keeps the best iterate per column and stops once every column
    sits far above its own floor, returning the best iterates.  Runs on
    the card unless ``device="cpu"`` (``b``'s device; the operators
    take and return tensors there)."""
    dev = _device.resolve(device, "lstsq_cgls")
    b = _device.place(b, dev, "lstsq_cgls")
    squeeze = b.ndim == 1
    bm = (b[:, None] if squeeze else b).to(torch.float32)
    m, k = bm.shape

    r_s = None
    if r_precond is not None:
        r_s = torch.as_tensor(r_precond).to(dev, torch.float32)
    elif gen is not None:
        l = max(int(embed * n), n + 8)
        l = -(-l // 8) * 8
        # B^T = A^T G accumulated block by block; only (m, c) of G lives
        blocks = []
        for j in range(0, l, sketch_cols):
            c = min(sketch_cols, l - j)
            blocks.append(rmatvec(_normal(gen, (m, c), dev)).to(
                torch.float32))
        bt = torch.cat(blocks, dim=1)                # (n, l)
        r_s = torch.linalg.qr(bt.T, mode="r").R
        r_s = r_s * torch.where(torch.diagonal(r_s) < 0, -1.0, 1.0)[:, None]

    if r_s is None:
        def apply_n(v):
            return v
        apply_nt = apply_n
    else:
        def apply_n(v):
            return _solve_upper(r_s, v)

        def apply_nt(v):
            return _solve_upper(r_s, v, trans=True)

    def mv(y):                       # Ahat y = A N y
        return matvec(apply_n(y)).to(torch.float32)

    def rmv(u):                      # Ahat^T u = N^T A^T u
        return apply_nt(rmatvec(u).to(torch.float32))

    def csq(v):                      # per-column squared norms (k,)
        return torch.sum(v * v, dim=0)

    s = rmv(bm)
    g0 = csq(s)                      # ||Ahat^T b||^2 per column
    g0_safe = torch.clamp_min(g0, 1e-30)
    y = torch.zeros(n, k, dtype=torch.float32, device=dev)
    r, p, gamma = bm, s, g0
    y_best, g_best = y, g0
    i = 0
    while i < max_iters:
        rel_best = torch.sqrt(torch.max(g_best / g0_safe))
        # diverged: EVERY column sits >= 1e4x above its own best gamma
        # (~100x in gradient norm): past the float32 floor no column can
        # improve, and further steps only amplify noise
        diverged = torch.all(gamma > 1e4 * torch.clamp_min(g_best, 1e-30))
        rel_h, div_h = torch.stack([rel_best, diverged.float()]).tolist()
        if not rel_h > tol or div_h:
            break
        q = mv(p)
        qq = csq(q)
        alpha = torch.where(qq > 0, gamma / torch.where(qq > 0, qq, 1.0), 0.0)
        y = y + alpha[None, :] * p
        r = r - alpha[None, :] * q
        s = rmv(r)
        gamma_new = csq(s)
        beta = torch.where(gamma > 0,
                           gamma_new / torch.where(gamma > 0, gamma, 1.0), 0.0)
        p = s + beta[None, :] * p
        improved = gamma_new < g_best
        y_best = torch.where(improved[None, :], y, y_best)
        g_best = torch.minimum(gamma_new, g_best)
        gamma = gamma_new
        i += 1
    x = apply_n(y_best)
    info = {"iters": i, "grad_rel": torch.sqrt(g_best / g0_safe)}
    return (x[:, 0] if squeeze else x), info
