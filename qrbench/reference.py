"""The plain reference: judges a QR (Q, R) of A in float64.

Plain PyTorch, imports nothing of the program.  It reads the program's
Q and R only to judge them, in blocks of rows so that it fits beside the
inputs on the device:

- ``orth``: ||Q^T Q - I||_F / sqrt(n), Q's orthogonality;
- ``resid``: ||A - Q R||_F / ||A||_F, the factorization's residual;
- ``r_err``: ||R - R_ref||_F / ||R_ref||_F over R's unique rows, both in
  canonical signs (diag >= 0), where R_ref is the reference's own float64
  Householder QR of A, by blocks of rows and a QR of their stacked R
  factors.  With zeroed columns only the rows above the first of them are
  unique; the rows below depend on the basis chosen for the null
  direction.

A row-sharded A (one shard a rank) is judged the same way: ``reduce``
sums a float64 tensor over the ranks and ``gather`` stacks the ranks'
(n, n) factors; both default to one rank.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

BLOCK_ROWS = 1 << 18
F64 = torch.float64


def _blocks(m: int, block_rows: int):
    return ((i, min(i + block_rows, m)) for i in range(0, m, block_rows))


def canonical_r(r: torch.Tensor) -> torch.Tensor:
    """R with each row's sign flipped so that the diagonal is >= 0 (a zero
    diagonal keeps its row)."""
    d = torch.diagonal(r)
    return r * torch.where(d < 0, -1.0, 1.0).to(r.dtype)[:, None]


def r_factor(a: torch.Tensor, block_rows: int = BLOCK_ROWS,
             gather: Callable | None = None) -> torch.Tensor:
    """The float64 R (n, n) of A's Householder QR, diag >= 0: the R of each
    block of rows, then the R of their stack (over the ranks too)."""
    n = a.shape[1]
    rs = [torch.linalg.qr(a[i:j].to(F64), mode="r")[1]
          for i, j in _blocks(a.shape[0], max(block_rows, n))]
    stack = torch.cat(rs)
    if gather is not None:
        stack = gather(stack)
    r = torch.linalg.qr(stack, mode="r")[1]
    if r.shape[0] < n:
        raise ValueError("the reference needs m >= n")
    return canonical_r(r)


def judge(a: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
          zero_columns=(), block_rows: int = BLOCK_ROWS,
          reduce: Callable | None = None,
          gather: Callable | None = None) -> dict:
    """{"orth", "resid", "r_err"} of the program's (q, r) for a (m, n) a
    (r_err None where no row of R is unique)."""
    reduce = reduce or (lambda t: t)
    m, n = a.shape
    if q.shape != a.shape or r.shape != (n, n):
        raise ValueError(f"Q {tuple(q.shape)} and R {tuple(r.shape)} do not "
                         f"fit A {tuple(a.shape)}")
    r64 = r.to(F64)
    gram = torch.zeros(n, n, dtype=F64, device=a.device)
    sq = torch.zeros(2, dtype=F64, device=a.device)
    for i, j in _blocks(m, block_rows):
        qb = q[i:j].to(F64)
        ab = a[i:j].to(F64)
        gram += qb.T @ qb
        d = ab - qb @ r64
        sq[0] += torch.sum(d * d)
        sq[1] += torch.sum(ab * ab)
    gram, sq = reduce(gram), reduce(sq)
    eye = torch.eye(n, dtype=F64, device=a.device)
    out = {"orth": float(torch.linalg.norm(gram - eye)) / math.sqrt(n),
           "resid": float(torch.sqrt(sq[0] / sq[1])), "r_err": None}
    rows = min(zero_columns) if len(zero_columns) else n
    if rows > 0:
        ref = r_factor(a, block_rows, gather)[:rows]
        got = canonical_r(r64)[:rows]
        out["r_err"] = float(torch.linalg.norm(got - ref)
                             / torch.linalg.norm(ref))
    return out
