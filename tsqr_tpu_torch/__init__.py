"""tsqr_tpu_torch: the tall-skinny QR library of ``tsqr_tpu`` in PyTorch,
with its kernels hand-written in CUDA for the NVIDIA H100.

Entry points (``qr_auto_fused``, ``fastqr``, ``tsqr``, ``qr``,
``panel_qr``) run on the CUDA card: an input elsewhere is moved there,
and without a card they raise ``RuntimeError``.  ``device="cpu"`` is
the explicit request for the CPU, where every kernel runs its plain
PyTorch version.
"""

import torch

# float32 products must be true float32: the corrected modes are graded
# against it, and TF32 keeps only 10 mantissa bits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from tsqr_tpu_torch.modes import ComputeMode  # noqa: E402
from tsqr_tpu_torch.core.auto import qr_auto_fused  # noqa: E402
from tsqr_tpu_torch.core.blockqr import qr  # noqa: E402
from tsqr_tpu_torch.core.cholqr import fastqr  # noqa: E402
from tsqr_tpu_torch.core.tsqr import tsqr  # noqa: E402
from tsqr_tpu_torch.ops.panel_qr import panel_qr  # noqa: E402

__all__ = ["ComputeMode", "qr_auto_fused", "fastqr", "tsqr", "qr",
           "panel_qr"]
