"""Panel QR façade: one (m, n) panel or a (B, m, n) batch.

Counterpart of ``tsqr_tpu/ops/panel_qr.py``: the blocked Householder QR
of :mod:`tsqr_tpu_torch.ops.householder` at a mode, returning Q (not
Q^T) and R in the mode's IO dtype.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.ops import householder
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor


def panel_qr(a: Tensor,
             mode: modes.ComputeMode | str | modes.Policy = "fp32",
             block: int = 8, device=None) -> tuple[Tensor, Tensor]:
    """QR of a single (m, n) panel or a (B, m, n) batch of panels, m >= n.
    Runs on the card unless ``device="cpu"``."""
    policy = modes.resolve(mode)
    a = _device.place(a, device, "panel_qr")
    if a.dim() not in (2, 3):
        raise ValueError(f"expected (m, n) or (B, m, n), got "
                         f"{tuple(a.shape)}")
    q, r = householder.blocked_householder_qr(a.to(torch.float32),
                                              mm=policy.mm, block=block)
    return q.to(policy.io_dtype), r.to(policy.io_dtype)
