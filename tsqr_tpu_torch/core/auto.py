"""Self-validating QR: ``qr_auto`` (try, measure, fall back) and
``qr_auto_fused``, the predictive ladder.

Counterpart of ``tsqr_tpu/core/auto.py``.  Each ``lax.cond`` of the
reference is a Python branch on one synced device scalar.  Within the
stream kernels' range (n <= ``cholqr._fused_n_max``: 1024 for
bf16x6_cor and bf16x3_cor, else 2048) and with fused methods, tiers 0-3
run the fused pipelines over ``ops.gram_stream.stream``; past it, or with
non-fused methods, they run the plain products of ``modes.gram`` and
``Policy.mm`` and the non-fused methods, as the reference does off its
kernel's range.  Tier 4 is ``core.blockqr.qr`` over the TSQR tree, whose
leaf is the panel kernel (``ops.panel_kernel``).
"""

from __future__ import annotations

import math

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr, cholqr, diff
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.ops import gram_stream
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils import validation

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
    Gram at bf16x6_cor grade within the fused range at that mode, a
    float64 Gram past it."""
    if q.shape[1] <= cholqr._fused_n_max(modes.resolve("bf16x6_cor")):
        return _orth_of_gram(gram_stream.gram_stream(q, "bf16x6_cor"))
    q64 = q.to(torch.float64)
    return _orth_of_gram(q64.T @ q64)


def _orth_device(q: Tensor) -> float:
    """||Q^T Q - I||_F / sqrt(n) from a float32 Gram on Q's device."""
    q32 = q.to(torch.float32)
    return float(_orth_of_gram(modes.mm_fp32(q32.T, q32)))


def qr_auto(a: Tensor, mode="fp32", fast_method: str = "cholqr3",
            device=None, **qr_kw) -> tuple[Tensor, Tensor, str]:
    """QR with automatic fast-path / fallback selection: returns
    (Q, R, method_used).

    For n <= 1024 it runs ``fastqr(method=fast_method)`` and measures
    Q's orthogonality (a float32 Gram at m <= 2^16, float64 above); if
    it misses the mode's tolerance, the corrected/fp32 modes retry with
    the iterated shifted CholeskyQR.  Last comes BlockQR over the
    Householder tree with CGS2 (``qr_kw`` go to :func:`blockqr.qr`).
    Runs on the card unless ``device="cpu"``."""
    policy = modes.resolve(mode)
    a = _device.place(a, device, "qr_auto")
    m, n = a.shape
    tol = _TOL.get(policy.mode, 1e-4)

    def orth(q):
        if m <= (1 << 16):
            return _orth_device(q)
        return validation.orthogonality_accurate(q)

    if n <= 1024:
        q, r = cholqr.fastqr(a, mode, method=fast_method, device=a.device)
        o = orth(q)
        if math.isfinite(o) and o < tol:
            return q, r, fast_method
        if policy.mode not in cholqr._CHEAP_DOT:
            q, r = cholqr.fastqr(a, mode, method="cholqr_iter",
                                 device=a.device)
            o = orth(q)
            if math.isfinite(o) and o < tol:
                return q, r, "cholqr_iter"
    qr_kw.setdefault("reorth", True)
    q, r = blockqr.qr(a, mode, device=a.device, **qr_kw)
    return q, r, "blockqr_tsqr"


@diff.differentiable(unless=lambda b: b["return_info"])
def qr_auto_fused(a: Tensor, mode="fp32",
                  fast_method: str = "cholqr1_fused",
                  fast_variant: str = "safe",
                  mid_method: str | None = "cholqr3_fused",
                  mid_variant: str = "compact",
                  impl: str | None = None,
                  leaf_rows: int | None = None,
                  fanin: int | None = None,
                  reorth: bool = True,
                  return_info: bool = False,
                  iter_tier: bool = True,
                  device=None):
    """Self-validating QR: the predictive ladder.

    Tier 0: G = A^T A (the stream kernel, or ``modes.gram`` off its
    range), its Cholesky, and an upper bound on kappa(A)^2.  Tier 1: if
    kappa2_est eps_mode safety < tol, finish the fast method (for cholqr1:
    one Q-writing pass reusing R1).  Tier 2: ``mid_method`` (the compact
    shifted CholeskyQR3 reusing G and gated by the Q-Gram of its last
    pass, or any method gated by Q's measured orthogonality).  Tier 3
    (corrected/fp32 modes): the iterated shifted CholeskyQR reusing G,
    gated the same way.  Tier 4 (unconditional): BlockQR over the
    Householder tree with CGS2 (``reorth``), whose leaf is the panel
    kernel: ``impl``, ``leaf_rows`` and ``fanin`` go to
    :func:`blockqr.qr`, and None takes the tree's defaults (the kernel
    leaf, the largest tile its shared memory holds at this n, fan-in
    ``tsqr.DEFAULT_FANIN``).  The fused pipelines run where the method
    is fused and n <= ``cholqr._fused_n_max``; elsewhere their non-fused
    siblings.

    Runs on the card unless ``device="cpu"``.  Differentiable in ``a``
    (``core/diff.py``) unless ``return_info``.

    Returns (q, r), or (q, r, info) with ``info["tier"]`` (an int) and
    ``info["kappa2_est"]`` (the (1, 1) tier-0 bound) when
    ``return_info``."""
    policy = modes.resolve(mode)
    a = _device.place(a, device, "qr_auto_fused")
    tol = _TOL[policy.mode]
    eps = _EPS_GATE[policy.mode]
    mname = policy.mode.value
    io = policy.io_dtype
    n = a.shape[1]
    in_range = n <= cholqr._fused_n_max(policy)
    fused = fast_method.endswith("_fused") and in_range
    a32 = cholqr._as_stream_input(a)

    # ---- tier 0: shared Gram + predictive kappa^2 bound ----
    if fused:
        g = gram_stream.gram_stream(a32, mname)
    else:
        g = modes.gram(a32.to(torch.float32), policy)
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
            if fused:
                q = gram_stream.stream(a32, (rinv1,), (mname,), write_q=True,
                                       out_dtype=io)
            else:
                q = policy.mm(a32.to(torch.float32), rinv1)
            return done(q, r1, 1)
        fm = fast_method if fused else base
        q, r = cholqr.fastqr(a, mode, method=fm, variant=fast_variant,
                             device=a.device)
        return done(q, r, 1)

    def tier4():
        q, r = blockqr.qr(a, policy, reorth=reorth, impl=impl,
                          leaf_rows=leaf_rows,
                          fanin=fanin or tsqr_mod.DEFAULT_FANIN,
                          device=a.device)
        return done(q, r, 4)

    if mid_method is None:
        return tier4()

    # ---- tier 2: robust shifted CholeskyQR3 ----
    mid_fused = mid_method.endswith("_fused") and in_range
    if (mid_fused and mid_method == "cholqr3_fused"
            and mid_variant == "compact"
            and policy.mode not in cholqr._CHEAP_DOT):
        q_m, r_m, gq = cholqr.cholqr3_fused(a32, mode, variant="compact",
                                            g1=g, return_qgram=True)
        orth_m = _orth_of_gram(gq)
    else:
        mv = mid_variant if policy.mode not in cholqr._CHEAP_DOT else "safe"
        mm = mid_method if mid_fused else mid_method.removesuffix("_fused")
        q_m, r_m = cholqr.fastqr(a, mode, method=mm,
                                 variant=mv if mm.endswith("_fused")
                                 else "safe", device=a.device)
        orth_m = _gate_orth(q_m)
    if bool(orth_m < tol):
        return done(q_m, r_m, 2)
    if policy.mode in cholqr._CHEAP_DOT or not iter_tier:
        return tier4()

    # ---- tier 3: iterated shifted CholeskyQR ----
    if in_range:
        q_i, r_i, gq_i = cholqr.cholqr_iter_fused(a32, mode, g1=g,
                                                  return_qgram=True)
        orth_i = _orth_of_gram(gq_i)
    else:
        q_i, r_i = cholqr.cholqr_iter(a, mode, g1=g)
        orth_i = _gate_orth(q_i)
    if bool(orth_i < tol):
        return done(q_i, r_i, 3)
    return tier4()
