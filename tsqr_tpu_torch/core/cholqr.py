"""CholeskyQR: the tall-skinny QR methods built from Gram matrices.

Counterpart of ``tsqr_tpu/core/cholqr.py``.  Two families:

* the fused methods (``cholqr1_fused``, ``cholqr2_fused``,
  ``cholqr3_fused``, ``cholqr_iter_fused``): every m-scale pass goes
  through ``ops.gram_stream.stream``, the stream kernels, for n up to
  ``_fused_n_max`` (the reference's range: 1024 for bf16x6_cor and
  bf16x3_cor, 2048 for the other modes); past it each delegates to its
  non-fused sibling, as the reference does;
* the non-fused methods (``cholqr1``, ``cholqr2``, ``cholqr3``,
  ``cholqr_iter``, ``rand_cholqr``): their products are the split
  products of ``modes.gram`` and ``Policy.mm``, plain float32 PyTorch
  matmuls of bf16-exact parts, as the reference leaves them to XLA.

Each ``lax.while_loop`` of the reference is a host loop that syncs once
per pass.  ``inplace=True`` writes Q over the caller's A (``alias_q`` of
the stream kernel); PyTorch has no buffer donation, so the caller's
tensor holds Q afterwards.  The reference's 128-lane sublane packing of
narrow panels is a TPU layout rule and is not ported: ``pack_panel``,
``unpack_panel`` and ``qr_packed`` keep its API over the unpacked
methods.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import diff
from tsqr_tpu_torch.ops import gram_stream
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor

_EPS32 = 6.0e-8


def _chol_r(g: Tensor, shift: float | Tensor | None = 0.0) -> Tensor:
    """Upper-triangular R with G (+ shift*I) = R^T R; all NaN where the
    Cholesky fails (as ``jnp.linalg.cholesky`` returns), which the ladder
    reads as "too ill-conditioned"."""
    n = g.shape[-1]
    g = (g + g.T) * 0.5
    if shift is not None:
        g = g + shift * torch.eye(n, dtype=g.dtype, device=g.device)
    low, info = torch.linalg.cholesky_ex(g)
    low = torch.where(info != 0, torch.full_like(low, float("nan")), low)
    return low.T


def _rinv(r: Tensor) -> Tensor:
    n = r.shape[-1]
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    return torch.linalg.solve_triangular(r, eye, upper=True)


def _fused_n_max(policy: modes.Policy) -> int:
    """Widest n the fused methods stream at the policy's mode, the
    reference's ``_fused_n_max`` (its TPU kernel's VMEM limit): 1024 for
    the multi-part corrected modes, 2048 for the others.  The stream
    kernels take every mode up to ``gram_stream.WIDE_N_MAX``, so each
    call of a pipeline in this range runs, whatever its correction's
    mode."""
    multi_part = (modes.ComputeMode.BF16X6_COR, modes.ComputeMode.BF16X3_COR)
    return 1024 if policy.mode in multi_part else gram_stream.WIDE_N_MAX


def _in_fused_range(a: Tensor, policy: modes.Policy) -> bool:
    return 1 <= a.shape[1] <= _fused_n_max(policy)


def _range_error(what: str, policy: modes.Policy, n: int) -> ValueError:
    """What a fused method raises for an option its non-fused sibling
    cannot honour (``what`` ends in its verb: "inplace requires")."""
    return ValueError(f"{what} n <= {_fused_n_max(policy)} (the "
                      f"fused-kernel range), got n={n}")


def _check_inplace(a: Tensor, policy: modes.Policy) -> None:
    if policy.io_dtype != a.dtype:
        raise ValueError(f"inplace requires io_dtype == a.dtype, got "
                         f"{policy.io_dtype} vs {a.dtype}")


def _as_stream_input(a: Tensor) -> Tensor:
    return a if a.dtype in (torch.bfloat16, torch.float32) \
        else a.to(torch.float32)


def _shift_value(g: Tensor, m: int, n: int) -> Tensor:
    """Cholesky-safeguard shift for a Gram accumulated without
    compensation, whose error is ~sqrt(m) eps ||G||:
    s = 11 (sqrt(m) n + n (n + 1)) eps ||G||_F, (1, 1)-shaped."""
    norm = torch.sqrt(torch.sum(g * g)).reshape(1, 1)
    return (11.0 * (math.sqrt(m) * n + n * (n + 1)) * _EPS32) * norm


def _q_pass(a: Tensor, r: Tensor, mm: Callable) -> Tensor:
    """Q = A R^-1 as one product with the explicit (n, n) inverse."""
    return mm(a, _rinv(r))


def _shift_value_fused(g: Tensor, n: int, chunk: int) -> Tensor:
    """Cholesky-safeguard shift for the compensated streaming Gram, whose
    error is ~sqrt(chunk) eps ||G||, independent of m:
    s = 11 (sqrt(chunk) n + n (n + 1)) eps ||G||_F, (1, 1)-shaped."""
    norm = torch.sqrt(torch.sum(g * g)).reshape(1, 1)
    return (11.0 * (math.sqrt(chunk) * n + n * (n + 1)) * _EPS32) * norm


def _compose(*factors: Tensor) -> Tensor:
    """Float32 product of small (n, n) factors."""
    acc = factors[0].to(torch.float32)
    for f in factors[1:]:
        acc = modes.mm_fp32(acc, f)
    return acc


M = modes.ComputeMode
# single- or triple-pass modes: the recompute pipelines re-derive Q1
_CHEAP_DOT = (M.BF16, M.BF16_NOCOR, M.BF16X3_NOCOR)
# Delta-trick correction mode per main mode (x += x @ (Rinv - I))
_DELTA_MODE = {M.BF16X6_COR: "bf16x3_cor", M.FP32: "bf16x3_cor"}
# relaxed dot mode of the compact pipeline's path-only middle pass
_RELAXED_MID = {M.BF16X6_COR: "bf16x3_cor", M.FP32: "bf16x3_cor",
                M.BF16X3_COR: "bf16x3_cor"}


def _delta(r: Tensor) -> Tensor:
    """Delta = Rinv - I."""
    n = r.shape[-1]
    return _rinv(r) - torch.eye(n, dtype=torch.float32, device=r.device)


# ---- kappa^2 estimation from a Gram matrix ---------------------------------

def _inf_norm11(x: Tensor) -> Tensor:
    return torch.max(torch.sum(torch.abs(x), dim=1)).reshape(1, 1)


def _psd_norm2_bound(x: Tensor, squarings: int = 4) -> Tensor:
    """Upper bound on ||X||_2 for symmetric PSD X, (1, 1)-shaped:
    ||X^(2^k)||_inf^(1/2^k), each squaring renormalised by its inf-norm.
    A scale of 0 or NaN gives NaN, which every gate reads as False."""
    s = _inf_norm11(x)
    b = s
    xh = x / s
    e = 0.5
    for _ in range(squarings):
        x2 = modes.mm_fp32(xh, xh)
        t = _inf_norm11(x2)
        xh = x2 / t
        b = b * t ** e
        e *= 0.5
    return b


# measured orthogonality floor of each mode's Gram arithmetic:
# cholqr1's orthogonality ~ c kappa(A)^2 eps_gate
_EPS_GATE = {
    M.FP32: 6e-8,
    M.BF16X6_COR: 6e-8,
    M.BF16X3_COR: 3e-7,
    M.BF16X3_NOCOR: 3e-6,
    M.BF16: 4e-3,
    M.BF16_NOCOR: 4e-3,
    M.BF16_NOCOR_EMU: 4e-3,
    M.TF32_NOCOR_EMU: 3e-6,
    M.BF16X3_COR_EMU: 3e-7,
    M.MIXED_COR_EMU: 3e-6,
}


def _k2_of_gram(g: Tensor) -> Tensor:
    """(1, 1)-shaped upper bound on kappa_2(X)^2 from X's Gram; NaN when
    the unshifted Cholesky fails."""
    rinv = _rinv(_chol_r(g, shift=None))
    minv = modes.mm_fp32(rinv, rinv.T)
    return (_psd_norm2_bound(g) * _psd_norm2_bound(minv)).reshape(1, 1)


# ---- the non-fused methods -------------------------------------------------

def cholqr1(a: Tensor, mode="fp32") -> tuple[Tensor, Tensor]:
    """Single-pass CholeskyQR: orthogonality ~ kappa(A)^2 eps_mode."""
    policy = modes.resolve(mode)
    a32 = a.to(torch.float32)
    r = _chol_r(modes.gram(a32, policy))
    q = _q_pass(a32, r, policy.mm)
    return q.to(policy.io_dtype), torch.triu(r).to(policy.io_dtype)


def _cholqr2_core(a32: Tensor, policy: modes.Policy) -> tuple[Tensor, Tensor]:
    """Two CholeskyQR iterations: (Q, R) in float32."""
    r1 = _chol_r(modes.gram(a32, policy))
    q1 = _q_pass(a32, r1, policy.mm)
    r2 = _chol_r(modes.gram(q1, policy))
    q = _q_pass(q1, r2, policy.mm)
    return q, torch.triu(modes.mm_fp32(r2, r1))


def cholqr2(a: Tensor, mode="fp32") -> tuple[Tensor, Tensor]:
    """CholeskyQR2: float32-grade orthogonality for kappa(A) <~ 4e3."""
    policy = modes.resolve(mode)
    q, r = _cholqr2_core(a.to(torch.float32), policy)
    return q.to(policy.io_dtype), r.to(policy.io_dtype)


def cholqr3(a: Tensor, mode="fp32") -> tuple[Tensor, Tensor]:
    """Shifted CholeskyQR3: a shifted first pass (which cannot break
    down), then CholeskyQR2; kappa(A) <~ 2e4 in float32."""
    policy = modes.resolve(mode)
    a32 = a.to(torch.float32)
    m, n = a32.shape
    g = modes.gram(a32, policy)
    r1 = _chol_r(g, shift=_shift_value(g, m, n))
    q2, r2 = _cholqr2_core(_q_pass(a32, r1, policy.mm), policy)
    r = torch.triu(modes.mm_fp32(r2, r1))
    return q2.to(policy.io_dtype), r.to(policy.io_dtype)


def pack_panel(a: Tensor) -> Tensor:
    """The reference's packed (ceil(m/p), p n) view of a narrow (m, n <=
    64) panel, p = 128 // n: row r holds rows p r .. p r + p - 1 of A,
    zero rows below m.  On the card the packing buys nothing (global
    memory has no 128-lane padding); it is kept for the API."""
    m, n = a.shape
    if n > 64:
        raise ValueError(f"pack_panel wants n <= 64, got n={n}")
    p = 128 // n
    a32 = a.to(torch.float32)
    m_pad = -(-m // p) * p
    if m_pad != m:
        a32 = torch.cat([a32, a32.new_zeros(m_pad - m, n)])
    return a32.reshape(m_pad // p, p * n)


def unpack_panel(qp: Tensor, m: int, n: int) -> Tensor:
    """Inverse of :func:`pack_panel`: (rows, p n) -> (m, n)."""
    return qp.reshape(-1, n)[:m]


def qr_packed(ap: Tensor, n: int, mode="fp32",
              method: str = "cholqr2") -> tuple[Tensor, Tensor]:
    """Thin QR of a packed panel (the view of :func:`pack_panel`), packed
    IO: returns (Q packed the same way, R (n, n)).  ``method`` is
    "cholqr1", "cholqr2" or "cholqr3", run on the unpacked rows; the zero
    pad rows add nothing to any Gram and stay zero in Q.

    Not differentiable by the entry rule of ``core/diff.py``, as in the
    JAX package: the packed identity is Ap = Qp kron(I_p, R), not
    A = QR.  Differentiate through :func:`fastqr` on the unpacked panel
    instead."""
    rows, pn = ap.shape
    if pn % n:
        raise ValueError(f"packed width {pn} not a multiple of n={n}")
    fns = {"cholqr1": cholqr1, "cholqr2": cholqr2, "cholqr3": cholqr3}
    if method not in fns:
        raise ValueError(f"qr_packed: unknown method {method!r}")
    q, r = fns[method](ap.reshape(rows * (pn // n), n), mode)
    return q.reshape(rows, pn), r


# ---- the fused methods -------------------------------------------------------

def cholqr1_fused(a: Tensor, mode="bf16", inplace: bool = False,
                  return_qgram: bool = False):
    """Single-pass CholeskyQR: one read of A (Gram), one read and one
    write (Q pass).  ``return_qgram=True`` also returns G = Q^T Q,
    accumulated in the Q-writing pass: (q, r, g).  ``inplace=True``
    writes Q over A (requires io_dtype == a.dtype)."""
    policy = modes.resolve(mode)
    if inplace:
        _check_inplace(a, policy)
    if not _in_fused_range(a, policy):
        if inplace or return_qgram:
            raise _range_error("inplace/return_qgram require", policy,
                               a.shape[1])
        return cholqr1(a, mode)
    mname = policy.mode.value
    a = _as_stream_input(a)
    g = gram_stream.gram_stream(a, mname)
    r = _chol_r(g)
    out = gram_stream.stream(a, (_rinv(r),), (mname,), write_q=True,
                             gram_mode=mname if return_qgram else None,
                             out_dtype=policy.io_dtype, alias_q=inplace)
    rt = torch.triu(r).to(policy.io_dtype)
    if return_qgram:
        q, p = out
        return q, rt, p + p.T
    return out, rt


def cholqr2_fused(a: Tensor, mode="fp32", variant: str = "safe",
                  inplace: bool = False) -> tuple[Tensor, Tensor]:
    """CholeskyQR2 on the stream kernel.

    ``variant``: "safe" (full grade throughout; kappa <~ 4e3), "fast"
    (the second factor by the Delta trick; kappa <~ 500), "fastest"
    (also Gram #1 in bf16; kappa <~ 10), "compact" (Q1 is never written:
    the final pass re-derives it from A and applies the Delta correction;
    kappa <~ 500) and "turbo" (fastest + compact; kappa <~ 10).  Every
    variant keeps a float32-grade residual.  ``inplace=True`` (compact and
    turbo, the pipelines whose last pass streams A itself) writes Q over
    A."""
    policy = modes.resolve(mode)
    if variant not in ("safe", "fast", "fastest", "compact", "turbo"):
        raise ValueError(f"cholqr2_fused: unknown variant {variant!r}")
    if inplace:
        if variant not in ("compact", "turbo"):
            raise ValueError("inplace requires the recompute pipeline "
                             "(variant 'compact' or 'turbo')")
        _check_inplace(a, policy)
    if not _in_fused_range(a, policy):
        if inplace:
            raise _range_error("inplace requires", policy, a.shape[1])
        if variant in ("compact", "turbo"):
            # the non-fused sibling writes Q1: no A + Q-only footprint
            raise _range_error(f"variant {variant!r} requires", policy,
                               a.shape[1])
        return cholqr2(a, mode)

    mname = policy.mode.value
    io = policy.io_dtype
    a = _as_stream_input(a)
    stream = gram_stream.stream
    g = gram_stream.gram_stream(
        a, "bf16" if variant in ("fastest", "turbo") else mname)
    r1 = _chol_r(g)
    dmode = _DELTA_MODE.get(policy.mode)
    if policy.mode in _CHEAP_DOT or variant in ("compact", "turbo"):
        # recompute pipeline: Q1 is re-derived from A, never written
        p2 = stream(a, (_rinv(r1),), (mname,), gram_mode=mname)
        r2 = _chol_r(p2 + p2.T)
        if variant in ("compact", "turbo") and dmode is not None:
            q = stream(a, (_rinv(r1), _delta(r2)), (mname, dmode),
                       residual=(False, True), write_q=True, out_dtype=io,
                       alias_q=inplace)
        else:
            q = stream(a, (_rinv(r1), _rinv(r2)), (mname, mname),
                       write_q=True, out_dtype=io, alias_q=inplace)
    else:
        q1, g2 = gram_stream.qpass_stream(a, _rinv(r1), mname)
        r2 = _chol_r(g2)
        if variant != "safe" and dmode is not None:
            q = stream(q1, (_delta(r2),), (dmode,), residual=(True,),
                       write_q=True, out_dtype=io)
        else:
            q = stream(q1, (_rinv(r2),), (mname,), write_q=True,
                       out_dtype=io)
    r = torch.triu(modes.mm_fp32(r2, r1))
    return q.to(io), r.to(io)


def cholqr3_fused(a: Tensor, mode="fp32", variant: str = "safe",
                  inplace: bool = False, g1: Tensor | None = None,
                  return_qgram: bool = False):
    """Shifted CholeskyQR3 on the stream kernel.

    ``variant`` "safe"/"fast" (the same program: the last factor always
    takes the Delta trick where the mode has one), "fastest" (Gram #1 in
    bf16) or "compact" (corrected/fp32 modes: Q1 is never written; the
    middle pass re-derives it with a relaxed dot, passes 3-4 apply the
    composed factor F2, re-derived bit for bit, and the last applies the
    Delta correction).

    Ladder hooks (compact only): ``g1`` is a precomputed full-grade Gram
    of ``a`` (skips pass 1); ``return_qgram=True`` also returns G = Q^T Q
    from the final pass: (q, r, gq).  ``inplace=True`` (compact only)
    writes Q over A.  Past the kernel's range the method delegates to
    :func:`cholqr3`, and compact, its hooks and ``inplace`` raise."""
    policy = modes.resolve(mode)
    if variant not in ("safe", "fast", "fastest", "compact"):
        raise ValueError(f"cholqr3_fused: unknown variant {variant!r}")
    if (g1 is not None or return_qgram) and variant != "compact":
        raise ValueError("g1/return_qgram are compact-pipeline hooks "
                         f"(got variant {variant!r})")
    if variant == "compact" and policy.mode in _CHEAP_DOT:
        raise ValueError(
            "cholqr3_fused: the cheap-dot modes already run a recompute "
            "pipeline under every variant; 'compact' applies to the "
            "corrected/fp32 modes")
    if inplace:
        if variant != "compact":
            raise ValueError("inplace requires the recompute pipeline "
                             "(variant 'compact')")
        _check_inplace(a, policy)
    if not _in_fused_range(a, policy):
        if inplace or g1 is not None or return_qgram or variant == "compact":
            # the non-fused sibling writes every intermediate panel
            raise _range_error("variant 'compact' (and its ladder hooks) "
                               "requires", policy, a.shape[1])
        return cholqr3(a, mode)

    mname = policy.mode.value
    io = policy.io_dtype
    a = _as_stream_input(a)
    m, n = a.shape
    g1_mode = "bf16" if variant == "fastest" else mname
    g = (g1.to(torch.float32) if g1 is not None
         else gram_stream.gram_stream(a, g1_mode))
    chunk = gram_stream.effective_chunk(m, n, gram_stream.GRAM_CHUNK)
    r1 = _chol_r(g, shift=_shift_value_fused(g, n, chunk))
    stream = gram_stream.stream

    if variant == "compact":
        mid = _RELAXED_MID.get(policy.mode, mname)
        p2 = stream(a, (_rinv(r1),), (mid,), gram_mode=mname)
        r2 = _chol_r(p2 + p2.T)
        f2 = _compose(_rinv(r1), _rinv(r2))
        p3 = stream(a, (f2,), (mname,), gram_mode=mname)
        r3 = _chol_r(p3 + p3.T)
        dmode = _DELTA_MODE.get(policy.mode)
        qg = mname if return_qgram else None
        if dmode is not None:
            out = stream(a, (f2, _delta(r3)), (mname, dmode),
                         residual=(False, True), write_q=True, gram_mode=qg,
                         out_dtype=io, alias_q=inplace)
        else:
            out = stream(a, (_compose(f2, _rinv(r3)),), (mname,),
                         write_q=True, gram_mode=qg, out_dtype=io,
                         alias_q=inplace)
        r = torch.triu(modes.mm_fp32(r3, modes.mm_fp32(r2, r1))).to(io)
        if return_qgram:
            q, p = out
            return q, r, p + p.T
        return out, r

    if policy.mode in _CHEAP_DOT:
        p2 = stream(a, (_rinv(r1),), (mname,), gram_mode=mname)
        r2 = _chol_r(p2 + p2.T)
        p3 = stream(a, (_rinv(r1), _rinv(r2)), (mname, mname),
                    gram_mode=mname)
        r3 = _chol_r(p3 + p3.T)
        q = stream(a, (_rinv(r1), _rinv(r2), _rinv(r3)),
                   (mname, mname, mname), write_q=True, out_dtype=io)
    else:
        q1, g2 = gram_stream.qpass_stream(a, _rinv(r1), mname)
        r2 = _chol_r(g2)
        q2, g3 = gram_stream.qpass_stream(q1, _rinv(r2), mname)
        r3 = _chol_r(g3)
        dmode = _DELTA_MODE.get(policy.mode)
        if dmode is not None:
            q = stream(q2, (_delta(r3),), (dmode,), residual=(True,),
                       write_q=True, out_dtype=io)
        else:
            q = stream(q2, (_rinv(r3),), (mname,), write_q=True,
                       out_dtype=io)
    r = torch.triu(modes.mm_fp32(r3, modes.mm_fp32(r2, r1)))
    return q.to(io), r.to(io)


# ---- iterated shifted CholeskyQR -------------------------------------------

def _iter_polish_k2(policy: modes.Policy) -> float:
    """kappa^2 below which an unshifted pass is attempted (the
    CholeskyQR2 breakdown budget kappa^2 eps <= 0.1)."""
    return 0.1 / _EPS_GATE.get(policy.mode, 1e-6)


# loop exits (NaN keeps looping): the measured ||X^T X - I||_F / sqrt(n)
# below _ORTH_EXIT, or the k2 bound below _K2_EXIT
_ORTH_EXIT = 3e-4
_K2_EXIT = 4.0


def _iter_shifted_loop(g0: Tensor, gram_of_f: Callable, shift_of_g: Callable,
                       n: int, k2_polish: float, max_shifted: int,
                       agree: Callable[[bool], bool] = bool):
    """The pass loop of the iterated method, on the host.

    Each pass factors G (unshifted when the k2 bound clears the polish
    budget and the unshifted Cholesky is finite, else shifted), composes
    the factor into F and R_total, and re-derives G = Gram(A F) in one
    m-scale pass.  The loop test reads (k2, orthg) in one sync per pass.
    ``agree`` makes the loop's exit one decision of every rank where
    ``gram_of_f`` is a collective (``parallel/comm.agree``).
    Returns (F, R_total, G, n_passes, orthg_exit)."""
    eye = torch.eye(n, dtype=torch.float32, device=g0.device)

    def orth_of(g):
        return (torch.linalg.norm(g - eye) / math.sqrt(n)).reshape(1, 1)

    i, f, rt, g = 0, eye, eye, g0
    k2, orthg = _k2_of_gram(g0), orth_of(g0)
    while True:
        k2_h, orthg_h = torch.cat([k2, orthg]).reshape(2).tolist()
        converged = orthg_h < _ORTH_EXIT or k2_h < _K2_EXIT  # NaN: False
        if agree(i >= max_shifted or converged):
            return f, rt, g, i, orthg_h
        r_u = _chol_r(g, shift=None)
        r_s = _chol_r(g, shift=shift_of_g(g))
        if k2_h < k2_polish:
            r1 = torch.where(torch.isnan(r_u).any(), r_s, r_u)
        else:
            r1 = r_s
        f = modes.mm_fp32(f, _rinv(r1))
        rt = modes.mm_fp32(r1, rt)
        g = gram_of_f(f)
        i += 1
        k2, orthg = _k2_of_gram(g), orth_of(g)


def cholqr_iter(a: Tensor, mode="fp32", g1: Tensor | None = None,
                max_shifted: int = 16) -> tuple[Tensor, Tensor]:
    """Iterated shifted CholeskyQR on plain products: Gram passes, shifted
    while the conditioning demands it, until the measured orthogonality
    of X = A F crosses ``_ORTH_EXIT``; then one unshifted factor of the
    exit Gram applied to the recomputed X.  Corrected/fp32 modes only.
    ``g1`` is a precomputed full-grade Gram of ``a``."""
    policy = modes.resolve(mode)
    if policy.mode in _CHEAP_DOT:
        raise ValueError(
            "cholqr_iter: the cheap-dot modes' Gram noise floor defeats "
            "the shifted-contraction analysis; use the corrected/fp32 "
            f"modes (got {policy.mode.value!r})")
    a32 = a.to(torch.float32)
    m, n = a32.shape

    def gram_of_f(f):
        g = modes.gram(policy.mm(a32, f), policy)
        return (g + g.T) * 0.5

    g0 = modes.gram(a32, policy) if g1 is None else g1.to(torch.float32)
    g0 = (g0 + g0.T) * 0.5
    f, rt, g, _, _ = _iter_shifted_loop(
        g0, gram_of_f, lambda gg: _shift_value(gg, m, n), n,
        _iter_polish_k2(policy), max_shifted)
    # the tail factors the exit Gram and applies it to the recomputed
    # x = A F, bit for bit the x that Gram measured
    r2 = _chol_r(g)
    rt = modes.mm_fp32(r2, rt)
    q = _q_pass(policy.mm(a32, f), r2, policy.mm)
    return q.to(policy.io_dtype), torch.triu(rt).to(policy.io_dtype)


def cholqr_iter_fused(a: Tensor, mode="fp32", g1: Tensor | None = None,
                      return_qgram: bool = False, max_shifted: int = 16):
    """Iterated shifted CholeskyQR on the stream kernel: each loop pass is
    one read of A (apply the composed F, accumulate the Gram of A F); the
    tail is one Q-writing pass applying the exit factor by the Delta
    trick.  ``g1`` is a precomputed Gram of ``a``; ``return_qgram=True``
    returns (q, r, gq) with gq = Q^T Q from the tail pass.  Past the
    kernel's range it delegates to :func:`cholqr_iter`."""
    policy = modes.resolve(mode)
    if policy.mode in _CHEAP_DOT:
        raise ValueError(
            "cholqr_iter_fused: corrected/fp32 modes only, got "
            f"{policy.mode.value!r}")
    if not _in_fused_range(a, policy):
        if g1 is not None or return_qgram:
            raise _range_error("g1/return_qgram require", policy, a.shape[1])
        return cholqr_iter(a, mode, max_shifted=max_shifted)

    mname = policy.mode.value
    io = policy.io_dtype
    a = _as_stream_input(a)
    m, n = a.shape
    chunk = gram_stream.effective_chunk(m, n, gram_stream.GRAM_CHUNK)

    def gram_of_f(f):
        p = gram_stream.stream(a, (f,), (mname,), gram_mode=mname)
        return p + p.T

    g0 = (gram_stream.gram_stream(a, mname) if g1 is None
          else g1.to(torch.float32))
    g0 = (g0 + g0.T) * 0.5
    f, rt, g, _, _ = _iter_shifted_loop(
        g0, gram_of_f, lambda gg: _shift_value_fused(gg, n, chunk), n,
        _iter_polish_k2(policy), max_shifted)

    r2 = _chol_r(g)
    rt = modes.mm_fp32(r2, rt)
    dmode = _DELTA_MODE.get(policy.mode)
    qg = mname if return_qgram else None
    if dmode is not None:
        out = gram_stream.stream(a, (f, _delta(r2)), (mname, dmode),
                                 residual=(False, True), write_q=True,
                                 gram_mode=qg, out_dtype=io)
    else:
        out = gram_stream.stream(a, (_compose(f, _rinv(r2)),), (mname,),
                                 write_q=True, gram_mode=qg, out_dtype=io)
    r = torch.triu(rt).to(io)
    if return_qgram:
        q, p = out
        return q, r, p + p.T
    return out, r


# ---- randomized (sketch-preconditioned) CholeskyQR --------------------------

def sketch_gaussian(a: Tensor, gen: torch.Generator, l: int,
                    chunk_rows: int = 1 << 16, mesh=None) -> Tensor:
    """B = Omega A with Omega an (l, m) standard Gaussian, drawn chunk by
    chunk of ``chunk_rows`` rows from ``gen`` (a generator on A's device)
    and never held whole; full float32 products whatever the mode.  The
    draw is not the JAX package's (its chunks are ``fold_in(key, i)``):
    statistics, not values, are the contract.

    ``mesh``: ``a`` is this rank's row shard (``parallel.mesh``) and
    ``gen`` is seeded alike on every rank; the sketch is
    ``parallel.dtsqr.dsketch`` seeded by one draw from ``gen``, B the
    same on every rank."""
    if mesh is not None:
        from tsqr_tpu_torch.parallel import dtsqr
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                 device=gen.device))
        return dtsqr.dsketch(a, seed, l, mesh, chunk_rows=chunk_rows,
                             device=a.device)
    m, n = a.shape
    a32 = a.to(torch.float32)
    b = a32.new_zeros(l, n)
    for c0 in range(0, m, chunk_rows):
        ach = a32[c0:c0 + chunk_rows]
        om = torch.randn(l, ach.shape[0], generator=gen, device=a.device,
                         dtype=torch.float32)
        b = b + modes.mm_fp32(om, ach)
    return b


def rand_cholqr(a: Tensor, mode="fp32", seed: int = 0, embed: float = 2.0,
                passes: int = 2, mesh=None) -> tuple[Tensor, Tensor]:
    """Randomized CholeskyQR: kappa-independent orthogonality in a fixed
    number of passes.  B = Omega A (l = embed n rows, rounded up to a
    multiple of 8), R_s = qr(B).R with a positive diagonal,
    X = A R_s^-1 (kappa(X) ~ 3-6 whatever kappa(A)), then ``passes``
    (1 or 2) CholeskyQR iterations on X at the mode's grade;
    R = R_x R_s.  Deterministic given ``seed`` on one device; R is unique
    (positive diagonal), so it agrees with the reference's to the mode's
    grade though the sketches differ.  Requires m >= l.

    ``mesh``: ``a`` is this rank's row shard (``parallel.mesh``); the
    sketch is ``parallel.dtsqr.dsketch`` from ``seed`` (one (l, n)
    all-reduce), the preconditioner QR is the same small work on every
    rank, and each Gram is summed over the ranks.  Q comes back as this
    rank's rows."""
    policy = modes.resolve(mode)
    if passes not in (1, 2):
        raise ValueError(f"rand_cholqr: passes must be 1 or 2, got {passes}")
    m, n = a.shape
    if mesh is not None:
        # parallel/ imports this module: imported at call time
        from tsqr_tpu_torch.parallel import comm, dtsqr, mesh as mesh_mod
        axis = mesh_mod.row_axes(mesh)
        m *= comm.axes_size(mesh, axis)

    def gram(x):   # summed over the ranks under a mesh
        g = modes.gram(x, policy)
        return g if mesh is None else comm.psum(g, mesh, axis)

    l = max(int(embed * n), n + 8)
    l = -(-l // 8) * 8
    if m < l:
        raise ValueError(
            f"rand_cholqr requires m >= {l} (= embed*{n} sketch rows) "
            f"for the subspace embedding, got m={m}; use blockqr/tsqr "
            "for near-square inputs")
    a32 = a.to(torch.float32)
    if mesh is None:
        gen = torch.Generator(device=a.device).manual_seed(seed)
        b = sketch_gaussian(a32, gen, l)
    else:
        b = dtsqr.dsketch(a32, seed, l, mesh, device=a.device)
    r_s = torch.linalg.qr(b, mode="r").R
    r_s = r_s * torch.where(torch.diagonal(r_s) < 0, -1.0, 1.0)[:, None]
    # the preconditioner is applied at full precision whatever the mode
    x = modes.mm_fp32(a32, _rinv(r_s))
    r1 = _chol_r(gram(x))
    q = _q_pass(x, r1, policy.mm)
    rt = modes.mm_fp32(r1, r_s)
    if passes == 2:
        r2 = _chol_r(gram(q))
        rt = modes.mm_fp32(r2, rt)
        q = _q_pass(q, r2, policy.mm)
    return q.to(policy.io_dtype), torch.triu(rt).to(policy.io_dtype)


_METHODS = {"cholqr1": cholqr1, "cholqr2": cholqr2, "cholqr3": cholqr3,
            "cholqr1_fused": cholqr1_fused, "cholqr2_fused": cholqr2_fused,
            "cholqr3_fused": cholqr3_fused, "cholqr_iter": cholqr_iter,
            "cholqr_iter_fused": cholqr_iter_fused,
            "rand_cholqr": rand_cholqr}


@diff.differentiable
def fastqr(a: Tensor, mode="fp32", method: str = "cholqr3",
           variant: str = "safe", device=None) -> tuple[Tensor, Tensor]:
    """Tall-skinny QR by one of the methods of ``_METHODS``: cholqr1/2/3
    (plain products), cholqr{1,2,3}_fused (the stream kernel),
    cholqr_iter[_fused] (the iterated shifted loop) and rand_cholqr
    (seed 0).  ``variant`` exists for cholqr2_fused and cholqr3_fused
    only; past the kernels' range (n > ``_fused_n_max``: 1024 for
    bf16x6_cor and bf16x3_cor, else 2048) the fused methods run their
    non-fused siblings, "fast"/"fastest" dropping to the full-grade
    product and "compact"/"turbo" raising.  Runs on the card unless
    ``device="cpu"``.  Differentiable in ``a`` (``core/diff.py``)."""
    a = _device.place(a, device, "fastqr")
    m, n = a.shape
    if m < n:
        raise ValueError(f"fastqr requires m >= n, got {tuple(a.shape)}")
    if method not in _METHODS:
        raise ValueError(f"fastqr: unknown method {method!r}")
    if variant != "safe":
        if method not in ("cholqr2_fused", "cholqr3_fused"):
            raise ValueError(
                f"method {method!r} has no variants (got {variant!r}); "
                f"variants exist for cholqr2_fused/cholqr3_fused only")
        return _METHODS[method](a, mode, variant=variant)
    return _METHODS[method](a, mode)


def fastqr_inplace(a: Tensor, mode="bf16", method: str = "cholqr1_fused",
                   variant: str = "compact", device=None
                   ) -> tuple[Tensor, Tensor]:
    """Capacity-mode QR: Q is written over A's own storage, so the peak
    device memory is about A alone (the stream kernel's float64 partials
    and the (n, n) factors besides).  PyTorch has no buffer donation: the
    caller's ``a`` holds Q afterwards, and the returned Q is a tensor on
    the same storage.  ``a`` must already be a contiguous tensor on the
    device the call runs on (the card unless ``device="cpu"``) with
    io_dtype == a.dtype: a copy would not alias it.  Methods:
    cholqr1_fused, cholqr2_fused (variant compact or turbo) and
    cholqr3_fused (variant compact)."""
    placed = _device.place(a, device, "fastqr_inplace")
    if not (isinstance(a, Tensor) and placed.data_ptr() == a.data_ptr()):
        raise ValueError(f"fastqr_inplace writes Q over the caller's tensor: "
                         f"a must already be a tensor on {placed.device}")
    a = placed
    m, n = a.shape
    if m < n:
        raise ValueError(f"fastqr_inplace requires m >= n, got "
                         f"{tuple(a.shape)}")
    if method == "cholqr1_fused":
        return cholqr1_fused(a, mode, inplace=True)
    if method in ("cholqr2_fused", "cholqr3_fused"):
        return _METHODS[method](a, mode, variant=variant, inplace=True)
    raise ValueError(f"fastqr_inplace: unsupported method {method!r}")
