"""Compute modes: runtime precision policies, in PyTorch.

Counterpart of ``tsqr_tpu/modes.py``: the same ten mode strings, the same
:class:`Policy` and the same split-corrected products.  Every split part is
a bf16-rounded value held in float32, and every product is a float32 matmul
of such parts.  A product of two bf16 values is exact in float32, so this
computes what a bf16 matrix unit with float32 accumulation computes.  (A
``torch.matmul`` of two bf16 tensors would return bf16 and lose the
correction terms.)

The package sets ``allow_tf32 = False`` and the "highest" float32 matmul
precision at import, so ``mm_fp32`` is true float32 on the card.  Nothing
here may run under ``torch.compile``: Inductor folds the
``x.to(bf16).float()`` round trips and collapses the split modes to plain
float32.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

Tensor = torch.Tensor

_F32_MANTISSA = 23


def clip_mantissa(x: Tensor, bits: int) -> Tensor:
    """Round a float32 tensor to ``bits`` explicit mantissa bits
    (round to nearest even), leaving NaN and Inf untouched."""
    x = x.to(torch.float32)
    drop = _F32_MANTISSA - bits
    if drop <= 0:
        return x
    # unsigned 32-bit arithmetic carried in int64 (torch has no uint32 ops)
    ix = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    half = 1 << (drop - 1)
    mask = (0xFFFFFFFF << drop) & 0xFFFFFFFF
    lsb = (ix >> drop) & 1
    rounded = (ix + half - 1 + lsb) & mask
    rounded = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded)
    out = rounded.to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def _bf(x: Tensor) -> Tensor:
    """x rounded to bf16 (nearest even), held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def to_bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16)


def split2(x: Tensor) -> tuple[Tensor, Tensor]:
    """2-way bf16 split x ≈ hi + lo, both parts held in float32."""
    x = x.to(torch.float32)
    hi = _bf(x)
    return hi, _bf(x - hi)


def split3(x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """3-way bf16 split x ≈ t0 + t1 + t2 (24 mantissa bits captured)."""
    x = x.to(torch.float32)
    t0 = _bf(x)
    r = x - t0
    t1 = _bf(r)
    return t0, t1, _bf(r - t1)


def mm_fp32(a: Tensor, b: Tensor) -> Tensor:
    """True float32 matmul (TF32 is disabled at package import)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def mm_bf16(a: Tensor, b: Tensor) -> Tensor:
    """Single-pass bf16 product with float32 accumulation."""
    return torch.matmul(_bf(a.to(torch.float32)), _bf(b.to(torch.float32)))


def mm_bf16x3_cor(a: Tensor, b: Tensor) -> Tensor:
    """2-way split corrected product: hi@hi + (hi@lo + lo@hi)."""
    ah, al = split2(a)
    bh, bl = split2(b)
    return torch.matmul(ah, bh) + (torch.matmul(ah, bl) + torch.matmul(al, bh))


def mm_bf16x3_nocor(a: Tensor, b: Tensor) -> Tensor:
    """tf32-grade 3-pass product.  In JAX this mode is
    ``lax.Precision.HIGH``: the 3-pass bf16 split on a TPU, plain float32
    on the CPU.  Here it is the 3-pass split written out, so it has the
    TPU's grade on every device."""
    return mm_bf16x3_cor(a, b)


def mm_bf16x3_cor_3term(a: Tensor, b: Tensor) -> Tensor:
    """2-way split with the extra lo@lo term, smallest term first."""
    ah, al = split2(a)
    bh, bl = split2(b)
    p = torch.matmul(al, bl)
    p = p + (torch.matmul(ah, bl) + torch.matmul(al, bh))
    return p + torch.matmul(ah, bh)


def mm_bf16x6_cor(a: Tensor, b: Tensor) -> Tensor:
    """3-way split corrected product, 6 passes, float32 grade; terms of
    combined residual order >= 3 are dropped."""
    a0, a1, a2 = split3(a)
    b0, b1, b2 = split3(b)
    mm = torch.matmul
    p = mm(a0, b2) + mm(a1, b1) + mm(a2, b0)
    p = p + (mm(a0, b1) + mm(a1, b0))
    return p + mm(a0, b0)


def gram(a: Tensor, policy: "Policy") -> Tensor:
    """G = A^T A under a policy, splitting A only once."""
    a = a.to(torch.float32)

    def dg(x, y):
        return torch.matmul(x.transpose(-2, -1), y)

    mode = policy.mode
    if mode is ComputeMode.BF16X3_COR:
        a0, a1 = split2(a)
        return dg(a0, a0) + (dg(a0, a1) + dg(a1, a0))
    if mode is ComputeMode.BF16X6_COR:
        a0, a1, a2 = split3(a)
        g = dg(a0, a2) + dg(a1, a1) + dg(a2, a0)
        g = g + (dg(a0, a1) + dg(a1, a0))
        return g + dg(a0, a0)
    if mode in (ComputeMode.BF16, ComputeMode.BF16_NOCOR):
        ab = _bf(a)
        return dg(ab, ab)
    return policy.mm(a.transpose(-2, -1), a)


# --- emulation matmuls (mantissa-clipped float32) ---------------------------


def mm_bf16_nocor_emu(a: Tensor, b: Tensor) -> Tensor:
    return mm_fp32(clip_mantissa(a, 7), clip_mantissa(b, 7))


def mm_tf32_nocor_emu(a: Tensor, b: Tensor) -> Tensor:
    return mm_fp32(clip_mantissa(a, 10), clip_mantissa(b, 10))


def mm_bf16x3_cor_emu(a: Tensor, b: Tensor) -> Tensor:
    ah = clip_mantissa(a, 7)
    al = clip_mantissa(a - ah, 7)
    bh = clip_mantissa(b, 7)
    bl = clip_mantissa(b - bh, 7)
    return mm_fp32(ah, bh) + (mm_fp32(ah, bl) + mm_fp32(al, bh))


def mm_mixed_cor_emu(a: Tensor, b: Tensor) -> Tensor:
    ah = clip_mantissa(a, 7)
    al = a.to(torch.float32) - ah
    bh = clip_mantissa(b, 7)
    bl = b.to(torch.float32) - bh
    return mm_fp32(ah, bh) + (mm_fp32(ah, bl) + mm_fp32(al, bh))


class ComputeMode(str, enum.Enum):
    """Runtime precision mode; the string values are those of the JAX
    package."""

    FP32 = "fp32"
    BF16 = "bf16"
    BF16_NOCOR = "bf16_nocor"
    BF16X3_NOCOR = "bf16x3_nocor"
    BF16X3_COR = "bf16x3_cor"
    BF16X6_COR = "bf16x6_cor"
    BF16_NOCOR_EMU = "bf16_nocor_emu"
    TF32_NOCOR_EMU = "tf32_nocor_emu"
    BF16X3_COR_EMU = "bf16x3_cor_emu"
    MIXED_COR_EMU = "mixed_cor_emu"

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass(frozen=True)
class Policy:
    """Resolved precision policy: IO dtype, working dtype and the matmul
    every layer uses."""

    mode: ComputeMode
    io_dtype: torch.dtype
    work_dtype: torch.dtype
    mm: Callable[[Tensor, Tensor], Tensor]
    corrected: bool = False

    @property
    def name(self) -> str:
        return self.mode.value

    @property
    def trailing_mm(self) -> Callable[[Tensor, Tensor], Tensor]:
        """Matmul of the BlockQR-level GEMMs: the mode's own product for
        the bf16 modes, plain float32 for every other mode."""
        if self.mode in (ComputeMode.BF16, ComputeMode.BF16_NOCOR):
            return self.mm
        return mm_fp32


_F32, _BF16 = torch.float32, torch.bfloat16
_POLICIES = {
    ComputeMode.FP32: Policy(ComputeMode.FP32, _F32, _F32, mm_fp32),
    ComputeMode.BF16: Policy(ComputeMode.BF16, _BF16, _BF16, mm_bf16),
    ComputeMode.BF16_NOCOR: Policy(ComputeMode.BF16_NOCOR, _F32, _BF16,
                                   mm_bf16),
    ComputeMode.BF16X3_NOCOR: Policy(ComputeMode.BF16X3_NOCOR, _F32, _F32,
                                     mm_bf16x3_nocor),
    ComputeMode.BF16X3_COR: Policy(ComputeMode.BF16X3_COR, _F32, _F32,
                                   mm_bf16x3_cor, corrected=True),
    ComputeMode.BF16X6_COR: Policy(ComputeMode.BF16X6_COR, _F32, _F32,
                                   mm_bf16x6_cor, corrected=True),
    ComputeMode.BF16_NOCOR_EMU: Policy(ComputeMode.BF16_NOCOR_EMU, _F32,
                                       _F32, mm_bf16_nocor_emu),
    ComputeMode.TF32_NOCOR_EMU: Policy(ComputeMode.TF32_NOCOR_EMU, _F32,
                                       _F32, mm_tf32_nocor_emu),
    ComputeMode.BF16X3_COR_EMU: Policy(ComputeMode.BF16X3_COR_EMU, _F32,
                                       _F32, mm_bf16x3_cor_emu,
                                       corrected=True),
    ComputeMode.MIXED_COR_EMU: Policy(ComputeMode.MIXED_COR_EMU, _F32, _F32,
                                      mm_mixed_cor_emu, corrected=True),
}


def resolve(mode: ComputeMode | str | Policy) -> Policy:
    """Resolve a mode name / enum / policy into a Policy."""
    if isinstance(mode, Policy):
        return mode
    return _POLICIES[ComputeMode(mode)]


ALL_MODES = tuple(ComputeMode)
MXU_MODES = (ComputeMode.BF16, ComputeMode.BF16_NOCOR,
             ComputeMode.BF16X3_NOCOR, ComputeMode.BF16X3_COR,
             ComputeMode.BF16X6_COR)
EMU_MODES = (ComputeMode.BF16_NOCOR_EMU, ComputeMode.TF32_NOCOR_EMU,
             ComputeMode.BF16X3_COR_EMU, ComputeMode.MIXED_COR_EMU)
