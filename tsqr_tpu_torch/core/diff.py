"""Automatic differentiation for the QR entry points.

Counterpart of ``tsqr_tpu/core/diff.py``.  The forward paths are not
differentiable as written: the kernels write through raw pointers into
fresh outputs, and the plain versions update their working tiles in
place.  Tracing autograd through them would be the wrong program anyway
(it would keep every intermediate panel of every pass).  So, as in the
JAX package, the rule sits at the entry-point boundary.  For any smooth
map A -> (Q, R) with A = QR, Q^T Q = I and R upper triangular, the
derivative depends only on the primal outputs:

    M  = (Q^T dQ - dQ^T Q) + (R dR^T - dR R^T)
    dA = Q (dR + tril(M) R^{-T}) + (dQ - Q Q^T dQ) R^{-T}

(:func:`qr_adjoint`, reverse mode) and :func:`qr_tangent` (forward
mode).  Either costs two (m, n) products and (n, n) triangular solves,
whatever method produced the factors; the kernels stay opaque.

:func:`differentiable` wraps an entry ``(a, ...) -> (Q, R)`` in a
``torch.autograd.Function``.  Its backward is written in differentiable
torch ops on the saved outputs, so a second order works, as
``torch.linalg.qr``'s rule does.  The move of ``a`` onto the entry's
device stays outside the Function, as a differentiable ``.to``: a CPU
tensor given to an entry on the card gets its gradient on the CPU.

Caveats (shared with ``torch.linalg.qr``'s rule): m >= n (every entry
enforces it) and a full-rank R; at exact rank deficiency the
factorization is not unique and the derivative grows with R^{-1}.
"""

from __future__ import annotations

import functools
import inspect

import torch
import torch.autograd.forward_ad as fwad

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def _rsolve(r: Tensor, x: Tensor) -> Tensor:
    """x R^{-1}, R upper triangular."""
    return torch.linalg.solve_triangular(r, x, upper=True, left=False)


def _rtsolve(r: Tensor, x: Tensor) -> Tensor:
    """x R^{-T}, R upper triangular."""
    return torch.linalg.solve_triangular(r.mT, x, upper=False, left=False)


def qr_tangent(q: Tensor, r: Tensor, da: Tensor) -> tuple[Tensor, Tensor]:
    """Tangents (dQ, dR) from the primal (Q, R) and the input tangent dA.

    The unique solution of dA = dQ R + Q dR, dQ^T Q + Q^T dQ = 0, dR
    upper triangular: with X = dA R^{-1} and S = Q^T X,

        dO = tril(S, -1) - tril(S, -1)^T
        dQ = X - Q (S - dO)
        dR = (S - dO) R

    Computed in float32 whatever the io dtype; the caller casts back."""
    f32 = torch.float32
    q, r, da = q.to(f32), r.to(f32), da.to(f32)
    x = _rsolve(r, da)
    s = modes.mm_fp32(q.T, x)
    low = torch.tril(s, -1)
    sd = s - (low - low.T)
    return x - modes.mm_fp32(q, sd), modes.mm_fp32(sd, r)


def qr_adjoint(q: Tensor, r: Tensor, dq: Tensor, dr: Tensor) -> Tensor:
    """Cotangent dA from (Q, R, dQ, dR): the explicit reduced-QR adjoint,
    in float32 whatever the io dtype.  The strictly lower triangle of dR
    is dropped first: R's zeros there are structural, so no cotangent
    flows through them."""
    f32 = torch.float32
    q, r = q.to(f32), r.to(f32)
    dq, dr = dq.to(f32), torch.triu(dr.to(f32))
    qdq = modes.mm_fp32(q.T, dq)
    m_ = (qdq - qdq.T) + (modes.mm_fp32(r, dr.T) - modes.mm_fp32(dr, r.T))
    return (modes.mm_fp32(q, dr + _rtsolve(r, torch.tril(m_)))
            + _rtsolve(r, dq - modes.mm_fp32(q, qdq)))


class _EntryQR(torch.autograd.Function):
    """(Q, R) = entry(a, *args, **kwargs) with the QR rule: ``a`` is the
    only tensor input; the entry and its other arguments pass through."""

    @staticmethod
    def forward(a, entry, args, kwargs):
        with torch.no_grad():
            return entry(a, *args, **kwargs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, r = output
        ctx.a_dtype = inputs[0].dtype
        ctx.save_for_backward(q, r)
        ctx.save_for_forward(q, r)

    @staticmethod
    def backward(ctx, dq, dr):
        q, r = ctx.saved_tensors
        return qr_adjoint(q, r, dq, dr).to(ctx.a_dtype), None, None, None

    @staticmethod
    def jvp(ctx, da, *_):
        q, r = ctx.saved_tensors
        dq, dr = qr_tangent(q, r, da)
        return dq.to(q.dtype), dr.to(r.dtype)


def _differentiating(a: Tensor) -> bool:
    """Whether a derivative can flow from ``a``: autograd records it, it
    carries a forward-mode tangent, or a ``torch.func`` transform wraps
    it."""
    if torch.is_grad_enabled() and a.requires_grad:
        return True
    if torch._C._functorch.is_functorch_wrapped_tensor(a):
        return True
    return fwad.unpack_dual(a).tangent is not None


def differentiable(fn=None, *, unless=None):
    """Decorator: reverse- and forward-mode differentiability in ``a`` for
    an ``(a, ..., device=None) -> (Q, R)`` entry point, through
    :func:`qr_adjoint` and :func:`qr_tangent`.

    Every other argument selects the method or precision and gets no
    gradient.  ``unless(bound_args)`` returning True calls the entry
    unwrapped: for flag combinations that change what it returns (e.g.
    ``return_info=True``), which keep their plain behaviour.  ``a`` is
    placed on the entry's device before the rule, by a differentiable
    move.  A call whose ``a`` can carry no derivative goes straight to
    the entry, before any argument is bound: the ladder's host syncs
    leave every microsecond of host time a call exposed."""
    if fn is None:
        return functools.partial(differentiable, unless=unless)
    sig = inspect.signature(fn)
    first = next(iter(sig.parameters))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        a = args[0] if args else kwargs.get(first)
        if not (isinstance(a, Tensor) and _differentiating(a)):
            return fn(*args, **kwargs)
        ba = sig.bind(*args, **kwargs)
        ba.apply_defaults()
        if unless is not None and unless(ba.arguments):
            return fn(*args, **kwargs)
        a = _device.place(a, ba.arguments.get("device"), fn.__name__)
        ba.arguments[first] = a
        return _EntryQR.apply(a, fn, ba.args[1:], ba.kwargs)

    return wrapper
