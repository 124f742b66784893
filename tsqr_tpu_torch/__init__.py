"""tsqr_tpu_torch: the tall-skinny QR ladder of ``tsqr_tpu`` in PyTorch,
with its streaming kernel hand-written in CUDA for the NVIDIA H100.

Entry points run on whatever device holds their input: CUDA tensors go
through the CUDA kernel, CPU tensors through its plain PyTorch version.
"""

import torch

# float32 products must be true float32: the corrected modes are graded
# against it, and TF32 keeps only 10 mantissa bits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from tsqr_tpu_torch.modes import ComputeMode  # noqa: E402
from tsqr_tpu_torch.core.auto import qr_auto_fused  # noqa: E402
from tsqr_tpu_torch.core.cholqr import fastqr  # noqa: E402

__all__ = ["ComputeMode", "qr_auto_fused", "fastqr"]
