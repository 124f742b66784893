"""tsqr_tpu_torch: the tall-skinny QR library of ``tsqr_tpu`` in PyTorch,
with its kernels hand-written in CUDA for the NVIDIA H100.

Entry points (``qr_auto_fused``, ``qr_auto``, ``fastqr``,
``fastqr_inplace``, ``tsqr``, ``qr``, ``panel_qr``, ``qr_packed``) run
on the CUDA card: an input elsewhere is moved there (``fastqr_inplace``
raises instead, since it writes Q over the caller's tensor), and
without a card they raise ``RuntimeError``.  ``device="cpu"`` is the
explicit request for the CPU, where every kernel runs its plain
PyTorch version.  ``fastqr``, ``tsqr``, ``qr`` and ``qr_auto_fused`` are
differentiable in ``a`` (``core/diff.py``), as in the JAX package.
"""

import torch

# float32 products must be true float32: the corrected modes are graded
# against it, and TF32 keeps only 10 mantissa bits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from tsqr_tpu_torch.modes import ComputeMode, Policy, resolve  # noqa: E402
from tsqr_tpu_torch.core.auto import qr_auto, qr_auto_fused  # noqa: E402
from tsqr_tpu_torch.core.blockqr import qr  # noqa: E402
from tsqr_tpu_torch.core.cholqr import (  # noqa: E402
    fastqr, fastqr_inplace, pack_panel, qr_packed, unpack_panel)
from tsqr_tpu_torch.core.tsqr import tsqr  # noqa: E402
from tsqr_tpu_torch.ops.panel_qr import panel_qr  # noqa: E402

# the port's own version: it moves with this package, not the JAX one
__version__ = "0.1.0"

__all__ = ["ComputeMode", "Policy", "resolve", "qr_auto_fused", "qr_auto",
           "fastqr", "fastqr_inplace", "tsqr", "qr", "panel_qr",
           "pack_panel", "qr_packed", "unpack_panel", "__version__"]
