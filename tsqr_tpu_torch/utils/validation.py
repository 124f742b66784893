"""Accuracy metrics: orthogonality ||Q^T Q - I||_F / sqrt(n), the
relative residual ||A - QR||_F / ||A||_F, their diagonal / off-diagonal
and per-block splits, and the exponent histogram.

Counterpart of ``tsqr_tpu/utils/validation.py``.  Three families:

* float64 on the host (``orthogonality``, ``orthogonality_each``,
  ``submatrix_orthogonality``, ``multi_orthogonality``, ``residual``):
  the golden path;
* float64 on the tensor's own device (``orthogonality_accurate``,
  ``residual_accurate``), independent of the kernels whose output they
  grade;
* float32 on the tensor's device (``*_device``, ``*_chunked``), in the
  reference's row-chunked form: bounded memory (no full-size copy or
  up-front cast of Q or A; each row chunk is cast on its own) and, for
  ``orthogonality_wide_device``, Kahan-compensated Gram slabs.  Their
  calibration against host float64 is what the accuracy harness's
  device metrics rest on.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def orthogonality(q) -> float:
    """||Q^T Q - I||_F / sqrt(n), float64 on the host."""
    q = _host64(q)
    n = q.shape[1]
    return float(np.linalg.norm(q.T @ q - np.eye(n)) / np.sqrt(n))


def _gram_dev64(q) -> np.ndarray:
    q = _host64(q)
    return q.T @ q - np.eye(q.shape[1])


def orthogonality_each(q) -> tuple[float, float]:
    """(diagonal, off-diagonal) parts of ||Q^T Q - I||_F / sqrt(n),
    float64 on the host."""
    g = _gram_dev64(q)
    d = np.diag(np.diag(g))
    s = np.sqrt(g.shape[0])
    return float(np.linalg.norm(d) / s), float(np.linalg.norm(g - d) / s)


def submatrix_orthogonality(q, tile: int = 16) -> np.ndarray:
    """Frobenius norms of the (tile x tile) blocks of Q^T Q - I (the
    block heatmap), float64 on the host."""
    g = _gram_dev64(q)
    nt = -(-g.shape[0] // tile)
    out = np.zeros((nt, nt))
    for i in range(nt):
        for j in range(nt):
            out[i, j] = np.linalg.norm(
                g[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile])
    return out


def multi_orthogonality(qs) -> float:
    """Worst orthogonality over a batch of tree-node Q factors (B, m, n)."""
    return max(orthogonality(q) for q in _host64(qs))


def residual(a, q, r) -> float:
    """||A - QR||_F / ||A||_F, float64 on the host."""
    a, q, r = _host64(a), _host64(q), _host64(r)
    return float(np.linalg.norm(a - q @ r) / np.linalg.norm(a))


def orthogonality_accurate(q: torch.Tensor) -> float:
    """||Q^T Q - I||_F / sqrt(n) in float64 on Q's device, without
    copying Q to the host."""
    q = q.to(torch.float64)
    n = q.shape[1]
    g = q.T @ q - torch.eye(n, dtype=torch.float64, device=q.device)
    return float(torch.linalg.norm(g)) / math.sqrt(n)


def residual_accurate(a: torch.Tensor, q: torch.Tensor,
                      r: torch.Tensor) -> float:
    """||A - QR||_F / ||A||_F in float64 on the tensors' device."""
    a64 = a.to(torch.float64)
    d = a64 - q.to(torch.float64) @ r.to(torch.float64)
    return float(torch.linalg.norm(d) / torch.linalg.norm(a64))


def orthogonality_device(q: torch.Tensor) -> torch.Tensor:
    """||Q^T Q - I||_F / sqrt(n) in float32 on Q's device, one product
    (the speed harness's quick check); a 0-dim tensor."""
    q = q.to(torch.float32)
    n = q.shape[1]
    g = q.T @ q - torch.eye(n, device=q.device)
    return torch.linalg.norm(g) / math.sqrt(n)


def residual_device(a: torch.Tensor, q: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """||A - QR||_F / ||A||_F in float32 on the tensors' device, one
    product; a 0-dim tensor."""
    a = a.to(torch.float32)
    d = a - q.to(torch.float32) @ r.to(torch.float32)
    return torch.linalg.norm(d) / torch.linalg.norm(a)


def orthogonality_wide_device(q: torch.Tensor, col_block: int = 2048,
                              row_chunk: int = 8192) -> torch.Tensor:
    """||Q^T Q - I||_F / sqrt(n) in float32 on Q's device, for any n.

    For each block of ``col_block`` columns the (n, cb) Gram slab is
    summed over row chunks of ``row_chunk`` rows with Kahan compensation,
    and its distance from the identity slab is added into a running
    squared norm: memory is two (n, cb) slabs and one row chunk, and the
    measurement error ~ eps sqrt(row_chunk) does not grow with m.  Each
    row chunk is cast to float32 on its own (a bf16 Q is never copied
    whole).  A 0-dim tensor."""
    m, n = q.shape
    total = torch.zeros((), dtype=torch.float32, device=q.device)
    for c0 in range(0, n, col_block):
        cb = min(col_block, n - c0)
        g = torch.zeros(n, cb, dtype=torch.float32, device=q.device)
        comp = torch.zeros_like(g)
        for r0 in range(0, m, row_chunk):
            qc = q[r0:r0 + row_chunk].to(torch.float32)
            y = qc.T @ qc[:, c0:c0 + cb] - comp
            t = g + y
            comp = (t - g) - y
            g = t
        g[c0:c0 + cb] -= torch.eye(cb, device=q.device)
        total = total + torch.sum(g * g)
    return torch.sqrt(total) / math.sqrt(n)


def _residual_sums(ac: torch.Tensor, qc: torch.Tensor, r32: torch.Tensor,
                   d2: torch.Tensor, a2: torch.Tensor):
    ac = ac.to(torch.float32)
    d = ac - qc.to(torch.float32) @ r32
    return d2 + torch.sum(d * d), a2 + torch.sum(ac * ac)


def residual_device_chunked(a: torch.Tensor, q: torch.Tensor,
                            r: torch.Tensor,
                            row_chunk: int = 4096) -> torch.Tensor:
    """||A - QR||_F / ||A||_F in float32 on the tensors' device, over row
    chunks of ``row_chunk`` rows: the m x n difference is never formed,
    and A and Q are read in place, a chunk at a time.  A 0-dim
    tensor."""
    r32 = r.to(torch.float32)
    d2 = torch.zeros((), dtype=torch.float32, device=q.device)
    a2 = torch.zeros_like(d2)
    for r0 in range(0, a.shape[0], row_chunk):
        d2, a2 = _residual_sums(a[r0:r0 + row_chunk], q[r0:r0 + row_chunk],
                                r32, d2, a2)
    return torch.sqrt(d2) / torch.sqrt(a2)


def residual_regen_chunked(gen_chunk: Callable[[int], torch.Tensor],
                           q: torch.Tensor, r: torch.Tensor,
                           row_chunk: int) -> torch.Tensor:
    """||A - QR||_F / ||A||_F where A's row chunks are made again.

    For the in-place pipelines, whose A no longer exists when the metrics
    run: test matrices are deterministic functions of a seed, so
    ``gen_chunk(i)`` returns rows [i row_chunk, (i + 1) row_chunk) of A
    bit for bit instead of a second m x n buffer being held.  A 0-dim
    tensor on Q's device."""
    m = q.shape[0]
    if m % row_chunk:
        raise ValueError(f"row_chunk {row_chunk} must divide m={m}")
    r32 = r.to(torch.float32)
    d2 = torch.zeros((), dtype=torch.float32, device=q.device)
    a2 = torch.zeros_like(d2)
    for i in range(m // row_chunk):
        d2, a2 = _residual_sums(gen_chunk(i).to(q.device),
                                q[i * row_chunk:(i + 1) * row_chunk], r32,
                                d2, a2)
    return torch.sqrt(d2) / torch.sqrt(a2)


def exponent_distribution(x, name: str = "") -> dict[int, int]:
    """Histogram {binary exponent: count} of the finite nonzero elements
    of ``x`` taken as float32, on the tensor's own device (a numpy array
    on the CPU): the exponent is frexp's minus one, so 1.0 counts under 0.
    ``name`` labels the study and is not used."""
    del name
    x = torch.as_tensor(x).detach().to(torch.float32).reshape(-1)
    x = x[torch.isfinite(x) & (x != 0)]
    if x.numel() == 0:
        return {}
    vals, counts = torch.unique(torch.frexp(x).exponent - 1,
                                return_counts=True)
    return {int(v): int(c) for v, c in zip(vals.tolist(), counts.tolist())}
