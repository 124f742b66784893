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
projections.  Q and R are filled in place, panel by panel.

``_ablate`` is the profiling hook of ``harness/profile.blockqr_breakdown``:
the same program with the panel factorizations or the trailing
projections taken out, timed against the full one.
"""

from __future__ import annotations

from typing import Callable

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import cholqr, diff
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils import trace

Tensor = torch.Tensor

DEFAULT_PANEL_WIDTH = 128


def _project(mm: Callable, qp: Tensor, x: Tensor,
             reduce: Callable[[Tensor], Tensor]) -> tuple[Tensor, Tensor]:
    """One CGS pass's two products against Q: (S, X - Q S) with
    S = Q^T X, the contraction summed by ``reduce``.  Each product adds
    one to the counter ``blockqr.project``."""
    trace.count("blockqr.project", 2)
    s = reduce(mm(qp.T, x))
    return s, x - mm(qp, s)


def _factor(tsqr_fn: Callable, x: Tensor, c0: int,
            cgs_pass: int) -> tuple[Tensor, Tensor]:
    """One panel factorization, in the span ``blockqr.panel`` (attrs c0,
    w and pass: 1, or 2 for CGS2's second)."""
    with trace.span("blockqr.panel", c0=c0, w=x.shape[1],
                    **{"pass": cgs_pass}):
        return tsqr_fn(x)


def _panel_step(q: Tensor, r: Tensor, a_b: Tensor, c0: int, mm: Callable,
                tsqr_fn: Callable, reorth: bool, full: bool = False,
                project: bool = True,
                reduce: Callable[[Tensor], Tensor] = lambda x: x) -> None:
    """One BlockQR panel, in place: project against Q, factor, write
    Q_b and R's column block at c0.  The projections run against the
    growing slice Q[:, :c0], or with ``full`` against all of Q, whose
    columns at >= c0 are zero so that the products agree; the leading
    panel (c0 = 0) skips the projections, which are provably zero, and
    so does every panel without ``project``.  Each CGS pass's products
    are one span ``blockqr.project`` (attrs c0, w, pass) and each
    factorization one ``blockqr.panel``; the step adds one to the
    counter ``blockqr.panels``.

    ``reduce`` wraps the two projection contractions (Q^T A_b and
    Q^T Q_b): the identity here, a sum over the ranks in the distributed
    BlockQR (``parallel/dtsqr.py``), whose Q holds this rank's rows
    only."""
    trace.count("blockqr.panels")
    w = a_b.shape[1]
    first = c0 == 0 or not project
    qp = q if full else q[:, :c0]
    if first:
        r12 = None
        a_p = a_b
    else:
        with trace.span("blockqr.project", c0=c0, w=w, **{"pass": 1}):
            r12, a_p = _project(mm, qp, a_b, reduce)
    q_b, r2 = _factor(tsqr_fn, a_p, c0, 1)
    if not reorth:
        r22 = r2
    else:
        # CGS2; on the leading panel S2 = Q^T Q_b = 0: a second QR pass
        if not first:
            with trace.span("blockqr.project", c0=c0, w=w, **{"pass": 2}):
                s2, q_b = _project(mm, qp, q_b, reduce)
        q_b, w_fac = _factor(tsqr_fn, q_b, c0, 2)
        if not first:
            r12 = r12 + mm(s2, r2)
        r22 = mm(w_fac, r2)
    if r12 is not None:
        r[:qp.shape[1], c0:c0 + w] = r12
    q[:, c0:c0 + w] = q_b
    r[c0:c0 + w, c0:c0 + w] = r22


@diff.differentiable(unless=lambda b: b["_ablate"] is not None)
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
       _ablate: str | None = None,
       device=None) -> tuple[Tensor, Tensor]:
    """Thin QR of any (m, n) matrix with m >= n: returns (Q (m, n),
    R (n, n)).  Runs on the card unless ``device="cpu"``.  Differentiable
    in ``a`` (``core/diff.py``).

    panel_method: "tsqr" (the Householder tree; ``leaf_rows``,
    ``fanin``, ``impl`` and ``leaf_qr`` go to :func:`tsqr`) or a
    CholeskyQR method of ``cholqr._METHODS``, at its default variant.
    loop: "auto" | "unroll" | "fori" (see the module docstring); "auto"
    unrolls.

    _ablate: profiling hook, the counterpart of the reference's in-line
    PROFILE_BREAKDOWN timers.  "no_panel" replaces each panel
    factorization by (A', I); "no_project" skips the trailing projections
    (every panel is factored as panel 0 is).  The time of the full call
    less that of an ablated one is the ablated phase's.  The factors are
    meaningless under ablation, and the gradient rule does not wrap such
    a call."""
    if _ablate not in (None, "no_panel", "no_project"):
        raise ValueError(f"unknown _ablate {_ablate!r}")
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

    if _ablate == "no_panel":
        def _tsqr(x):  # noqa: F811 (the profiling stand-in)
            return x, torch.eye(x.shape[1], dtype=x.dtype, device=x.device)

    with trace.span("blockqr"):
        if n <= nb:
            trace.count("blockqr.panels")
            q, r = _factor(_tsqr, a, 0, 1)
            if reorth:  # single panel: CGS2's second pass
                q, w_fac = _factor(_tsqr, q, 0, 2)
                r = mm(w_fac, r)
            return q.to(policy.io_dtype), torch.triu(r).to(policy.io_dtype)

        if loop not in ("auto", "unroll", "fori"):
            raise ValueError(f"unknown loop strategy {loop!r}")
        q = a.new_zeros(m, n)
        r = a.new_zeros(n, n)
        for c0 in range(0, n, nb):
            _panel_step(q, r, a[:, c0:c0 + nb], c0, mm, _tsqr, reorth,
                        full=loop == "fori", project=_ablate != "no_project")
        return q.to(policy.io_dtype), torch.triu(r).to(policy.io_dtype)
