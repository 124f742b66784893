"""The predictive QR ladder, tiers 0-3, on the stream kernel.

Counterpart of ``qr_auto_fused`` in ``tsqr_tpu/core/auto.py``.  Each
``lax.cond`` of the reference is a Python branch on one synced device
scalar; the ladder always runs the fused pipelines over
``ops.gram_stream.stream``.  Tier 4 (the Householder tree) is not ported
yet: an input that reaches it raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import cholqr
from tsqr_tpu_torch.ops import gram_stream

Tensor = torch.Tensor

M = modes.ComputeMode
# orthogonality acceptance per mode (~10x the mode's intrinsic grade)
_TOL = {
    M.FP32: 1e-5,
    M.BF16: 5e-2,
    M.BF16_NOCOR: 5e-2,
    M.BF16X3_NOCOR: 1e-3,
    M.BF16X3_COR: 1e-4,
    M.BF16X6_COR: 1e-5,
    M.BF16_NOCOR_EMU: 5e-2,
    M.TF32_NOCOR_EMU: 1e-3,
    M.BF16X3_COR_EMU: 1e-4,
    M.MIXED_COR_EMU: 1e-3,
}
_EPS_GATE = cholqr._EPS_GATE
_SAFETY = 8.0  # covers the O(1) constant in orth ~ c kappa^2 eps

_TIER4 = "tier 4 (Householder tree) is not ported yet — ROADMAP A.5"


def _kappa2_max(base_method: str, eps: float, tol: float) -> float:
    """Predictive tier-1 admission threshold on the kappa^2(A) bound."""
    if base_method == "cholqr1":
        return tol / (eps * _SAFETY)
    if base_method == "cholqr2":
        return 0.1 / eps
    return min(1e8, 2.5 / eps)


def _orth_of_gram(g: Tensor) -> Tensor:
    n = g.shape[-1]
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    return torch.linalg.norm(g - eye) / math.sqrt(n)


def _gate_orth(q: Tensor) -> Tensor:
    """Orthogonality of Q for the ladder's gates: the Kahan streaming
    Gram at bf16x6_cor grade, on either device."""
    return _orth_of_gram(gram_stream.gram_stream(q, "bf16x6_cor"))


def qr_auto_fused(a: Tensor, mode="fp32",
                  fast_method: str = "cholqr1_fused",
                  fast_variant: str = "safe",
                  mid_method: str | None = "cholqr3_fused",
                  mid_variant: str = "compact",
                  return_info: bool = False,
                  iter_tier: bool = True):
    """Self-validating QR: the predictive ladder.

    Tier 0: stream G = A^T A, Cholesky it, and bound kappa(A)^2 from
    above.  Tier 1: if kappa2_est eps_mode safety < tol, finish the fast
    method (for cholqr1: one Q-writing pass reusing R1).  Tier 2: the
    compact shifted CholeskyQR3 reusing G, gated by the Q-Gram of its last
    pass.  Tier 3 (corrected/fp32 modes): the iterated shifted
    CholeskyQR, gated the same way.  Tier 4 raises
    ``NotImplementedError`` (not ported).

    Returns (q, r), or (q, r, info) with ``info["tier"]`` (an int) and
    ``info["kappa2_est"]`` (the (1, 1) tier-0 bound) when
    ``return_info``."""
    policy = modes.resolve(mode)
    tol = _TOL[policy.mode]
    eps = _EPS_GATE[policy.mode]
    mname = policy.mode.value
    io = policy.io_dtype
    n = a.shape[1]
    if not fast_method.endswith("_fused") or (
            mid_method is not None and not mid_method.endswith("_fused")):
        raise NotImplementedError(
            "the ladder's non-fused methods are not ported yet — "
            "ROADMAP A.3")
    cholqr._check_range(a, policy, "qr_auto_fused")
    a32 = cholqr._as_stream_input(a)

    # ---- tier 0: shared Gram + predictive kappa^2 bound ----
    g = gram_stream.gram_stream(a32, mname)
    g = (g + g.T) * 0.5
    r1 = cholqr._chol_r(g, shift=None)
    rinv1 = cholqr._rinv(r1)
    minv = modes.mm_fp32(rinv1, rinv1.T)
    kappa2_est = (cholqr._psd_norm2_bound(g)
                  * cholqr._psd_norm2_bound(minv)).reshape(1, 1)
    base = fast_method.removesuffix("_fused")
    ok1 = bool(kappa2_est < _kappa2_max(base, eps, tol))  # False for NaN

    def done(q, r, tier):
        q, r = q.to(io), torch.triu(r).to(io)
        if return_info:
            return q, r, {"tier": tier, "kappa2_est": kappa2_est}
        return q, r

    if ok1:
        if base == "cholqr1":
            q = gram_stream.stream(a32, (rinv1,), (mname,), write_q=True,
                                   out_dtype=io)
            return done(q, r1, 1)
        q, r = cholqr.fastqr(a, mode, method=fast_method,
                             variant=fast_variant)
        return done(q, r, 1)
    if mid_method is None:
        raise NotImplementedError(_TIER4)

    # ---- tier 2: robust shifted CholeskyQR3 ----
    if (mid_method == "cholqr3_fused" and mid_variant == "compact"
            and policy.mode not in cholqr._CHEAP_DOT):
        q_m, r_m, gq = cholqr.cholqr3_fused(a32, mode, variant="compact",
                                            g1=g, return_qgram=True)
        orth_m = _orth_of_gram(gq)
    else:
        mv = mid_variant if policy.mode not in cholqr._CHEAP_DOT else "safe"
        if mid_method != "cholqr3_fused":
            mv = "safe"
        q_m, r_m = cholqr.fastqr(a, mode, method=mid_method, variant=mv)
        orth_m = _gate_orth(q_m)
    if bool(orth_m < tol):
        return done(q_m, r_m, 2)
    if policy.mode in cholqr._CHEAP_DOT or not iter_tier:
        raise NotImplementedError(_TIER4)

    # ---- tier 3: iterated shifted CholeskyQR ----
    q_i, r_i, gq_i = cholqr.cholqr_iter_fused(a32, mode, g1=g,
                                              return_qgram=True)
    if bool(_orth_of_gram(gq_i) < tol):
        return done(q_i, r_i, 3)
    raise NotImplementedError(_TIER4)
