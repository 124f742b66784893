"""Batched products at a split mode on the tensor cores: the TSQR tree's
Q build.

:func:`batched_split_mm` computes y[b] = x[b] @ c[b] for a float32
(B, M, K) x and (B, K, N) c on the card at 1, 2 or 3 bf16 parts, the
products of ``modes.mm_bf16``, ``mm_bf16x3_cor`` / ``mm_bf16x3_nocor``
and ``mm_bf16x6_cor``: one launch of ``csrc/split_mm.cu`` a call
(counted in ``launches.split_mm``), which splits the operands on chip
and runs the mode's products on ``mma.sync``.  It launches the kernel or
raises: there is no fallback, and CPU tensors raise.  Its plain version,
:func:`split_mm_reference`, is the mode's own product.

The kernel takes every shape, so the products it serves have no range in
n: any B, M, K, N (ragged edges masked, never padded into x).  Either
operand may have its rows or its columns contiguous (the tree's x is the
transposed view of the panel kernels' Q^T); any other strides raise.

:data:`ERROR_LIMIT` is the kernel's accuracy at each part count, as the
card tests hold it: :func:`split_mm_error` of a launch against the
float64 product stays under it, and :func:`split_mm_control`, the same
product a part short, goes over it.
"""

from __future__ import annotations

import ctypes

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.ops import gram_stream
from tsqr_tpu_torch.utils import trace

Tensor = torch.Tensor

# bf16 parts of each split mode's own product; no other product (fp32,
# the emulation modes, a caller's own) has a kernel route
PARTS = {modes.mm_bf16: 1, modes.mm_bf16x3_cor: 2, modes.mm_bf16x3_nocor: 2,
         modes.mm_bf16x6_cor: 3}
_PLAIN = {1: modes.mm_bf16, 2: modes.mm_bf16x3_cor, 3: modes.mm_bf16x6_cor}


# the most split_mm_error a launch reads at each part count: set between
# the kernel's largest reading on the card and the smallest of
# split_mm_control's (PERF.md, the kernel table's S1 row)
ERROR_LIMIT = {1: 4e-3, 2: 4e-5, 3: 5e-7}


def split_mm_reference(x: Tensor, c: Tensor, parts: int) -> Tensor:
    """Plain version: the mode's own product on the batch."""
    return _PLAIN[parts](x, c)


def split_mm_control(x: Tensor, c: Tensor, parts: int) -> Tensor:
    """The product a part short, which :data:`ERROR_LIMIT` refuses: the
    plain version at ``parts - 1``, and below one part the operands
    rounded to float8 e4m3's 3 mantissa bits, the tensor cores' next
    format below bf16."""
    if parts > 1:
        return _PLAIN[parts - 1](x, c)
    return torch.matmul(modes.clip_mantissa(x, 3), modes.clip_mantissa(c, 3))


def split_mm_error(y: Tensor, x: Tensor, c: Tensor) -> float:
    """max |y - x @ c| / (|x| @ |c|), the product and its scale in
    float64: every part count's error in units of the operands' own
    size, whatever the signs cancel."""
    x, c = x.double(), c.double()
    return float(((y.double() - x @ c).abs() / (x.abs() @ c.abs())).max())


def _check(x: Tensor, c: Tensor, parts: int) -> None:
    if parts not in _PLAIN:
        raise ValueError(f"split_mm takes 1, 2 or 3 parts, got {parts!r}")
    if x.dim() != 3 or c.dim() != 3:
        raise ValueError(f"split_mm wants (B, M, K) and (B, K, N), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if x.shape[0] != c.shape[0] or x.shape[2] != c.shape[1]:
        raise ValueError(f"split_mm: {tuple(x.shape)} @ {tuple(c.shape)} "
                         "do not match")


def _layout(t: Tensor) -> tuple[int, int]:
    """(transposed, leading stride) of a (B, R, C) operand: rows
    contiguous (0, the row stride) or columns contiguous (1, the column
    stride); a unit extent takes either."""
    _, rows, cols = t.shape
    sr, sc = t.stride(1), t.stride(2)
    if sc == 1 or cols == 1:
        return 0, sr if rows > 1 else cols
    if sr == 1 or rows == 1:
        return 1, sc if cols > 1 else rows
    raise ValueError(f"split_mm reads operands with rows or columns "
                     f"contiguous, got strides {t.stride()}")


def _lib():
    from tsqr_tpu_torch.ops import _build

    lib = _build.load("split_mm")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.split_mm_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, cll, cll,
                                        ci, cll, cll, ci, ci, vp]
        lib.split_mm_launch.restype = ci
        lib._typed = True
    return lib


def batched_split_mm(x: Tensor, c: Tensor, parts: int) -> Tensor:
    """y (B, M, N) float32, y[b] = x[b] @ c[b] at ``parts`` bf16 parts.

    One launch of ``split_mm.cu``: x and c float32 on one cuda device,
    each with rows or columns contiguous; y made here.  The checks raise
    before any launch."""
    _check(x, c, parts)
    if x.device.type != "cuda" or c.device != x.device:
        raise ValueError(f"split_mm runs on one cuda device, got "
                         f"{x.device} and {c.device}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise ValueError(f"split_mm reads float32 operands, got {x.dtype} "
                         f"and {c.dtype}")
    (B, M, K), N = x.shape, c.shape[2]
    xt, ldx = _layout(x)
    ct, ldc = _layout(c)
    y = torch.empty(B, M, N, dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().split_mm_launch(
        x.data_ptr(), c.data_ptr(), y.data_ptr(), B, M, K, N,
        x.stride(0) if B > 1 else 0, ldx, xt,
        c.stride(0) if B > 1 else 0, ldc, ct, parts, stream)
    gram_stream._raise_on(err, "split_mm launch")
    trace.count("launches.split_mm")
    return y
