"""CholeskyQR pipelines on the streaming kernel: the methods of the
predictive ladder's tiers 1-3.

Counterpart of ``tsqr_tpu/core/cholqr.py``, restricted to what the ladder
calls: ``cholqr1_fused``, ``cholqr3_fused`` and ``cholqr_iter_fused`` with
their helpers.  Every m-scale pass goes through
``ops.gram_stream.stream``.  Each ``lax.while_loop`` of the reference is a
host loop that syncs once per pass.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the non-fused ``cholqr1``/``cholqr3``/``cholqr_iter``,
``cholqr2``/``cholqr2_fused``, ``rand_cholqr``, and ``inplace``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.ops import gram_stream
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor

_EPS32 = 6.0e-8
_NOT_PORTED = "is not ported yet — ROADMAP A.3"


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
    """Widest n the stream kernel takes, for every mode: its shared
    memory holds a TILE_ROWS x n tile, its split parts and the (n, n)
    Kahan sum and compensation."""
    del policy
    return gram_stream.N_MAX


def _check_range(a: Tensor, policy: modes.Policy, what: str) -> None:
    m, n = a.shape
    if not 1 <= n <= _fused_n_max(policy):
        raise NotImplementedError(
            f"{what} at n={n}: the stream kernel takes n <= "
            f"{_fused_n_max(policy)}, and the non-fused methods beyond it "
            f"{_NOT_PORTED}")


def _as_stream_input(a: Tensor) -> Tensor:
    return a if a.dtype in (torch.bfloat16, torch.float32) \
        else a.to(torch.float32)


def _shift_value_fused(g: Tensor, n: int, chunk: int) -> Tensor:
    """Cholesky-safeguard shift for the Kahan streaming Gram, whose
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


# ---- the methods -------------------------------------------------------------

def cholqr1_fused(a: Tensor, mode="bf16", inplace: bool = False,
                  return_qgram: bool = False):
    """Single-pass CholeskyQR: one read of A (Gram), one read and one
    write (Q pass).  ``return_qgram=True`` also returns G = Q^T Q,
    accumulated in the Q-writing pass: (q, r, g)."""
    policy = modes.resolve(mode)
    if inplace:
        raise NotImplementedError(f"inplace {_NOT_PORTED}")
    _check_range(a, policy, "cholqr1_fused")
    mname = policy.mode.value
    a = _as_stream_input(a)
    g = gram_stream.gram_stream(a, mname)
    r = _chol_r(g)
    out = gram_stream.stream(a, (_rinv(r),), (mname,), write_q=True,
                             gram_mode=mname if return_qgram else None,
                             out_dtype=policy.io_dtype)
    rt = torch.triu(r).to(policy.io_dtype)
    if return_qgram:
        q, p = out
        return q, rt, p + p.T
    return out, rt


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
    from the final pass: (q, r, gq)."""
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
        raise NotImplementedError(f"inplace {_NOT_PORTED}")
    _check_range(a, policy, "cholqr3_fused")

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
                         out_dtype=io)
        else:
            out = stream(a, (_compose(f2, _rinv(r3)),), (mname,),
                         write_q=True, gram_mode=qg, out_dtype=io)
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
                       n: int, k2_polish: float, max_shifted: int):
    """The pass loop of the iterated method, on the host.

    Each pass factors G (unshifted when the k2 bound clears the polish
    budget and the unshifted Cholesky is finite, else shifted), composes
    the factor into F and R_total, and re-derives G = Gram(A F) in one
    m-scale pass.  The loop test reads (k2, orthg) in one sync per pass.
    Returns (F, R_total, G, n_passes, orthg_exit)."""
    eye = torch.eye(n, dtype=torch.float32, device=g0.device)

    def orth_of(g):
        return (torch.linalg.norm(g - eye) / math.sqrt(n)).reshape(1, 1)

    i, f, rt, g = 0, eye, eye, g0
    k2, orthg = _k2_of_gram(g0), orth_of(g0)
    while True:
        k2_h, orthg_h = torch.cat([k2, orthg]).reshape(2).tolist()
        converged = orthg_h < _ORTH_EXIT or k2_h < _K2_EXIT  # NaN: False
        if i >= max_shifted or converged:
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


def cholqr_iter_fused(a: Tensor, mode="fp32", g1: Tensor | None = None,
                      return_qgram: bool = False, max_shifted: int = 16):
    """Iterated shifted CholeskyQR on the stream kernel: each loop pass is
    one read of A (apply the composed F, accumulate the Gram of A F); the
    tail is one Q-writing pass applying the exit factor by the Delta
    trick.  ``g1`` is a precomputed Gram of ``a``; ``return_qgram=True``
    returns (q, r, gq) with gq = Q^T Q from the tail pass."""
    policy = modes.resolve(mode)
    if policy.mode in _CHEAP_DOT:
        raise ValueError(
            "cholqr_iter_fused: corrected/fp32 modes only, got "
            f"{policy.mode.value!r}")
    _check_range(a, policy, "cholqr_iter_fused")
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


_METHODS = {"cholqr1_fused": cholqr1_fused, "cholqr3_fused": cholqr3_fused,
            "cholqr_iter_fused": cholqr_iter_fused}
_NOT_PORTED_METHODS = ("cholqr1", "cholqr2", "cholqr3", "cholqr2_fused",
                       "cholqr_iter", "rand_cholqr")


def fastqr(a: Tensor, mode="fp32", method: str = "cholqr3_fused",
           variant: str = "safe", device=None) -> tuple[Tensor, Tensor]:
    """Tall-skinny QR through one of the ported methods: cholqr1_fused,
    cholqr3_fused (variants safe, fast, fastest, compact) and
    cholqr_iter_fused.  Runs on the card unless ``device="cpu"``."""
    a = _device.place(a, device, "fastqr")
    m, n = a.shape
    if m < n:
        raise ValueError(f"fastqr requires m >= n, got {tuple(a.shape)}")
    if method in _NOT_PORTED_METHODS:
        raise NotImplementedError(f"method {method!r} {_NOT_PORTED}")
    if method not in _METHODS:
        raise ValueError(f"fastqr: unknown method {method!r}")
    if variant != "safe":
        if method != "cholqr3_fused":
            raise ValueError(
                f"method {method!r} has no variants (got {variant!r})")
        return cholqr3_fused(a, mode, variant=variant)
    return _METHODS[method](a, mode)
