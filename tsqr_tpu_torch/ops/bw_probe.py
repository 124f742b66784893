"""Two memory-bandwidth probes: a pure read and a read + write of a
float32 (m, n) A.

Counterpart of the Pallas probes ``read_reduce`` and ``copy_kernel`` of
``scripts/bw_experiments.py``: :func:`read_reduce` gives
out (8, n) = A.view(-1, 8, n).sum(0), :func:`copy` gives y = A * c with
c = 1 + 2^-23.  On a CUDA tensor each launches its kernel of
``csrc/bw_probe.cu`` (or raises: there is no fallback); on a CPU tensor
each runs its plain PyTorch version.  ``rows_per_cta`` sets the kernel's
grid (the rows each CTA covers), as the TPU probes' ``chunk`` set theirs;
the result does not depend on it.
"""

from __future__ import annotations

import ctypes

import torch

Tensor = torch.Tensor

COPY_SCALE = 1.0 + 2.0 ** -23   # the float32 nearest 1.0000001
DEFAULT_ROWS_PER_CTA = 4096
COPY_DEFAULT_ROWS_PER_CTA = 8   # the copy's default: many short CTAs

# Kernel launches, counted where each kernel is launched.
READ_LAUNCHES = 0       # bw_read_kernel
READ_SUM_LAUNCHES = 0   # bw_read_sum_kernel
COPY_LAUNCHES = 0       # bw_copy_kernel


def read_reduce_reference(a: Tensor) -> Tensor:
    """Plain version of :func:`read_reduce`: the (8, n) sum of A's 8-row
    groups, summed in float64 as the kernel sums, rounded to float32."""
    m, n = a.shape
    return a.view(m // 8, 8, n).sum(0, dtype=torch.float64).to(torch.float32)


def copy_reference(a: Tensor) -> Tensor:
    """Plain version of :func:`copy`: A * c in float32."""
    return a * COPY_SCALE


def _lib():
    from tsqr_tpu_torch.ops import _build

    lib = _build.load("bw_probe")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bw_read_launch.argtypes = [vp, vp, cll, ci, cll, ci, vp]
        lib.bw_read_sum.argtypes = [vp, vp, ci, ci, vp]
        lib.bw_copy_launch.argtypes = [vp, vp, cll, cll, ctypes.c_float, ci,
                                       vp]
        for f in (lib.bw_read_launch, lib.bw_read_sum, lib.bw_copy_launch):
            f.restype = ci
        lib._typed = True
    return lib


def _check(a: Tensor, what: str) -> None:
    if a.dim() != 2 or a.dtype != torch.float32:
        raise ValueError(f"{what} takes a 2-D float32 A, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {a.device}")


def _check_card(a: Tensor, what: str, rows_per_cta: int) -> None:
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"the {what} kernel reads a contiguous, 16-byte "
                         "aligned A")
    if rows_per_cta < 8 or rows_per_cta % 8:
        raise ValueError(f"rows_per_cta must be a positive multiple of 8, "
                         f"got {rows_per_cta}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def read_reduce(a: Tensor,
                rows_per_cta: int = DEFAULT_ROWS_PER_CTA) -> Tensor:
    """out (8, n) float32 = sum over k of A[8k + j, c], m a multiple of 8:
    one read of A.  On the card: each CTA sums ``rows_per_cta`` rows into a
    float64 partial, and a second launch adds the partials in a fixed
    order."""
    global READ_LAUNCHES, READ_SUM_LAUNCHES
    _check(a, "read_reduce")
    m, n = a.shape
    if m % 8:
        raise ValueError(f"read_reduce sums 8-row groups: m must be a "
                         f"multiple of 8, got {m}")
    if a.device.type == "cpu":
        return read_reduce_reference(a)
    _check_card(a, "read_reduce", rows_per_cta)
    gpc = rows_per_cta // 8
    grid = -(-(m // 8) // gpc)
    partials = torch.empty(grid, 8, n, dtype=torch.float64, device=a.device)
    out = torch.empty(8, n, dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = _lib()
    _raise_on(lib.bw_read_launch(a.data_ptr(), partials.data_ptr(), m, n, gpc,
                                 grid, stream), "bw_read_kernel launch")
    READ_LAUNCHES += 1
    _raise_on(lib.bw_read_sum(partials.data_ptr(), out.data_ptr(), grid,
                              8 * n, stream), "bw_read_sum_kernel launch")
    READ_SUM_LAUNCHES += 1
    return out


def copy(a: Tensor,
         rows_per_cta: int = COPY_DEFAULT_ROWS_PER_CTA) -> Tensor:
    """y = A * c (c = ``COPY_SCALE``) into a new float32 tensor: one read
    and one write of A, bit for bit the plain version's.  On the card each
    CTA streams ``rows_per_cta`` contiguous rows."""
    global COPY_LAUNCHES
    _check(a, "copy")
    if a.device.type == "cpu":
        return copy_reference(a)
    _check_card(a, "copy", rows_per_cta)
    m, n = a.shape
    y = torch.empty_like(a)
    grid = -(-m // rows_per_cta)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _raise_on(_lib().bw_copy_launch(a.data_ptr(), y.data_ptr(), m * n,
                                    rows_per_cta * n, COPY_SCALE, grid,
                                    stream),
              "bw_copy_kernel launch")
    COPY_LAUNCHES += 1
    return y
