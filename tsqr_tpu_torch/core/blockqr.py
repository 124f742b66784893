"""BlockQR: column-blocked QR for wide matrices, with optional CGS2
reorthogonalization.

Counterpart of ``tsqr_tpu/core/blockqr.py``.  Panels of ``panel_width``
columns (default min(n, 128)) are factored left to right: each panel is
projected against the Q built so far (R12 = Q^T A_b, A' = A_b - Q R12),
factored by the TSQR tree (or a fused CholeskyQR method), and with
``reorth`` projected and factored a second time (CGS2).  For a single
panel CGS2's projections vanish and it is a second QR pass of Q_b, so
``reorth=True`` is never a silent no-op.  The projection and fix-up
products run at the mode's ``trailing_mm`` (float32 for the corrected
modes); the split products stay inside the panel factorization.

Both panel loops of the reference are one Python loop over
``_panel_step`` here: "unroll" (the default) projects against the
growing slice Q[:, :c0]; "fori" against the full (m, n) Q buffer whose
later columns are still zero, as the reference's ``lax.fori_loop`` body
does.  That loop exists in the reference only to bound trace time, which
eager PyTorch does not have, so "auto" always unrolls; "fori" is kept
for parity with the reference's call sites and costs the zero columns'
projections.  Q and R are filled in place, panel by panel.  The
reference's ``_ablate`` profiling hook is not ported: it belongs to the
harness's phase breakdown (ROADMAP A.8).
"""

from __future__ import annotations

from typing import Callable

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import cholqr, diff
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor

DEFAULT_PANEL_WIDTH = 128


def _panel_step(q: Tensor, r: Tensor, a_b: Tensor, c0: int, mm: Callable,
                tsqr_fn: Callable, reorth: bool, full: bool = False) -> None:
    """One BlockQR panel, in place: project against Q, factor, write
    Q_b and R's column block at c0.  The projections run against the
    growing slice Q[:, :c0], or with ``full`` against all of Q, whose
    columns at >= c0 are zero so that the products agree; the leading
    panel (c0 = 0) skips the projections, which are provably zero."""
    w = a_b.shape[1]
    first = c0 == 0
    qp = q if full else q[:, :c0]
    if first:
        r12 = None
        a_p = a_b
    else:
        r12 = mm(qp.T, a_b)
        a_p = a_b - mm(qp, r12)
    if not reorth:
        q_b, r22 = tsqr_fn(a_p)
    elif first:
        # CGS2 on the leading panel: S2 = Q^T Q_b = 0, a second QR pass
        q_b, r2 = tsqr_fn(a_p)
        q_b, w_fac = tsqr_fn(q_b)
        r22 = mm(w_fac, r2)
    else:
        q_b, r2 = tsqr_fn(a_p)
        s2 = mm(qp.T, q_b)
        q_b = q_b - mm(qp, s2)
        q_b, w_fac = tsqr_fn(q_b)
        r12 = r12 + mm(s2, r2)
        r22 = mm(w_fac, r2)
    if r12 is not None:
        r[:qp.shape[1], c0:c0 + w] = r12
    q[:, c0:c0 + w] = q_b
    r[c0:c0 + w, c0:c0 + w] = r22


@diff.differentiable
def qr(a: Tensor,
       mode: modes.ComputeMode | str | modes.Policy = "fp32",
       reorth: bool = False,
       panel_width: int | None = None,
       leaf_rows: int | None = None,
       fanin: int = tsqr_mod.DEFAULT_FANIN,
       impl: str | None = None,
       leaf_qr: Callable | None = None,
       panel_method: str = "tsqr",
       loop: str = "auto",
       device=None) -> tuple[Tensor, Tensor]:
    """Thin QR of any (m, n) matrix with m >= n: returns (Q (m, n),
    R (n, n)).  Runs on the card unless ``device="cpu"``.  Differentiable
    in ``a`` (``core/diff.py``).

    panel_method: "tsqr" (the Householder tree; ``leaf_rows``,
    ``fanin``, ``impl`` and ``leaf_qr`` go to :func:`tsqr`) or a
    CholeskyQR method of ``cholqr._METHODS``, at its default variant.
    loop: "auto" | "unroll" | "fori" (see the module docstring); "auto"
    unrolls."""
    policy = modes.resolve(mode)
    a = _device.place(a, device, "qr")
    m, n = a.shape
    if n > m:
        raise ValueError(f"BlockQR requires m >= n, got {tuple(a.shape)}")
    a = a.to(torch.float32)
    mm = policy.trailing_mm
    nb = min(panel_width or min(n, DEFAULT_PANEL_WIDTH), n)
    fp32_policy = modes.Policy(policy.mode, torch.float32, policy.work_dtype,
                               policy.mm, policy.corrected)

    if panel_method == "tsqr":
        def _tsqr(x):
            return tsqr_mod.tsqr(x, fp32_policy, leaf_rows=leaf_rows,
                                 fanin=fanin, impl=impl, leaf_qr=leaf_qr,
                                 device=x.device)
    elif panel_method in cholqr._METHODS:
        def _tsqr(x):
            return cholqr._METHODS[panel_method](x, fp32_policy)
    else:
        raise ValueError(f"unknown panel_method {panel_method!r}")

    if n <= nb:
        q, r = _tsqr(a)
        if reorth:  # single panel: CGS2's second pass
            q, w_fac = _tsqr(q)
            r = mm(w_fac, r)
        return q.to(policy.io_dtype), torch.triu(r).to(policy.io_dtype)

    if loop not in ("auto", "unroll", "fori"):
        raise ValueError(f"unknown loop strategy {loop!r}")
    q = a.new_zeros(m, n)
    r = a.new_zeros(n, n)
    for c0 in range(0, n, nb):
        _panel_step(q, r, a[:, c0:c0 + nb], c0, mm, _tsqr, reorth,
                    full=loop == "fori")
    return q.to(policy.io_dtype), torch.triu(r).to(policy.io_dtype)
