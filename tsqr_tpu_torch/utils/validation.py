"""Accuracy metrics: orthogonality ||Q^T Q - I||_F / sqrt(n) and the
relative residual ||A - QR||_F / ||A||_F.

``orthogonality`` and ``residual`` run in float64 on the host;
``orthogonality_accurate`` runs in float64 on Q's own device, so it is
independent of the stream kernel whose output it grades.
"""

from __future__ import annotations

import math

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
