"""The streaming pass of the CholeskyQR pipelines: chained dots, an
optional Q write and an optional Kahan-compensated half-Gram, in one read
of A.

Counterpart of ``tsqr_tpu/ops/pallas_gram.py``.  :func:`stream` launches
the CUDA kernel ``csrc/stream_gram.cu`` for a CUDA tensor and runs the
plain PyTorch version :func:`stream_reference` for a CPU tensor.  On a
CUDA tensor it launches the kernel or raises: there is no fallback.

The kernel's shapes: n <= ``N_MAX`` (128), any m; A float32 or bf16; up
to three dots; modes fp32, bf16, bf16_nocor, bf16x3_nocor, bf16x3_cor and
bf16x6_cor.  Its Gram is Kahan-compensated once per ``TILE_ROWS`` rows,
so ``stream`` takes ``chunk == TILE_ROWS`` on the card.  With ``alias_q``
it writes Q into A's own storage (each CTA reads a tile before it writes
that tile's rows), on either device.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tsqr_tpu_torch import modes

Tensor = torch.Tensor

TILE_ROWS = 16          # rows the kernel sums before one compensated add
N_MAX = 128             # widest n the kernel's shared memory holds
DEFAULT_CHUNK = TILE_ROWS
GRAM_CHUNK = TILE_ROWS
_BLOCK_CHUNKS = 1024    # chunks whose Gram contributions the plain
                        # version forms in one batched product

# Preprocessor defines of the kernel build; harness/phase_profile.py sets
# ("STREAM_GRAM_PROFILE",) to compile the phase timers in.
BUILD_DEFINES: tuple[str, ...] = ()

# Kernel launches, counted where each kernel is launched.
LAUNCHES = 0            # stream_gram_kernel
ALIAS_LAUNCHES = 0      # of those, with Q written over A (alias_q)
REDUCE_LAUNCHES = 0     # stream_gram_reduce_kernel

M = modes.ComputeMode
# split parts per mode: (parts, rounded to bf16); the residual order of
# the product terms kept is parts - 1.  bf16x3_nocor is the 3-pass split
# that lax.Precision.HIGH runs on a TPU.
_PARTS = {M.FP32: (1, False), M.BF16: (1, True), M.BF16_NOCOR: (1, True),
          M.BF16X3_NOCOR: (2, True), M.BF16X3_COR: (2, True),
          M.BF16X6_COR: (3, True)}


def _mode(mode) -> modes.ComputeMode:
    md = modes.resolve(mode).mode
    if md not in _PARTS:
        raise ValueError(f"unsupported in-kernel mode {md.value!r}")
    return md


def _kernel_code(md: modes.ComputeMode) -> int:
    parts, rounded = _PARTS[md]
    return parts if parts > 1 else int(rounded)


def _mode_parts(x: Tensor, md: modes.ComputeMode) -> tuple[list, int]:
    """Split a float32 operand into its parts for ``md``: x ≈ sum(parts);
    product terms of combined residual order above ``order`` are
    dropped."""
    parts, rounded = _PARTS[md]
    if not rounded:
        return [x], 0
    if parts == 1:
        return [modes._bf(x)], 0
    return list(modes.split2(x) if parts == 2 else modes.split3(x)), parts - 1


def _dot_mode(x: Tensor, r: Tensor, md: modes.ComputeMode) -> Tensor:
    """Split-corrected x @ r: the products of each residual order in one
    matmul (stacked along the contraction axis), orders added smallest
    first."""
    xp, order = _mode_parts(x, md)
    rp, _ = _mode_parts(r, md)
    if len(xp) == 1:
        return torch.matmul(xp[0], rp[0])
    acc = None
    for s in range(order, -1, -1):
        pairs = [(i, s - i) for i in range(len(xp)) if 0 <= s - i < len(rp)]
        t = torch.matmul(torch.cat([xp[i] for i, _ in pairs], dim=-1),
                         torch.cat([rp[j] for _, j in pairs], dim=-2))
        acc = t if acc is None else acc + t
    return acc


def _gram_half(x: Tensor, md: modes.ComputeMode) -> Tensor:
    """Half-Gram P of x (contracting the row axis; batched over leading
    axes): X^T X = P + P^T, terms added smallest order first."""
    xp, order = _mode_parts(x, md)
    acc = None
    for s in range(order, -1, -1):
        for i in range(len(xp)):
            j = s - i
            if i <= j < len(xp):
                t = torch.matmul(xp[i].transpose(-2, -1), xp[j])
                if i == j:
                    t = 0.5 * t
                acc = t if acc is None else acc + t
    return acc


def effective_chunk(m: int, n: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Rows summed before one compensated add of the Gram (the error
    budget of ``cholqr._shift_value_fused`` is ~sqrt(chunk) eps)."""
    del n
    return max(1, min(chunk, m))


def _check(a: Tensor, rinvs, dot_modes, write_q, gram_mode, residual,
           out_dtype=None, alias_q=False):
    if a.dim() != 2:
        raise ValueError(f"stream wants a 2-D A, got shape {tuple(a.shape)}")
    if len(rinvs) != len(dot_modes):
        raise ValueError("one mode per dot")
    if not write_q and gram_mode is None:
        raise ValueError("stream needs write_q or gram_mode")
    if alias_q:
        if not write_q:
            raise ValueError("alias_q requires write_q")
        if (out_dtype or a.dtype) != a.dtype:
            raise ValueError("alias_q requires out_dtype == a.dtype")
        if not a.is_contiguous():
            # a copy would hold Q, not the caller's tensor
            raise ValueError("alias_q requires a contiguous A")
    residual = tuple(residual) or (False,) * len(rinvs)
    if len(residual) != len(rinvs):
        raise ValueError("one residual flag per dot")
    return residual


def stream_reference(a: Tensor,
                     rinvs: Sequence[Tensor] = (),
                     dot_modes: Sequence[str] = (),
                     write_q: bool = False,
                     gram_mode: str | None = None,
                     chunk: int = DEFAULT_CHUNK,
                     out_dtype: torch.dtype | None = None,
                     residual: Sequence[bool] = (),
                     alias_q: bool = False):
    """Plain PyTorch version of :func:`stream`, on A's device.

    x = A (as float32); x = x @ rinvs[i] (or x + x @ rinvs[i] where
    residual[i]) at dot_modes[i]; Q = x in ``out_dtype``; P = the
    half-Gram of x at ``gram_mode``, its ``chunk``-row contributions added
    with Kahan compensation.  Returns [Q] if write_q, + [P] if gram_mode,
    as a tuple in that order (a single element unpacked).  With
    ``alias_q`` Q is copied into A, and A is returned as Q."""
    residual = _check(a, rinvs, dot_modes, write_q, gram_mode, residual,
                      out_dtype, alias_q)
    m, n = a.shape
    out_dtype = out_dtype or a.dtype
    x = a.to(torch.float32)
    for r, md, res in zip(rinvs, dot_modes, residual):
        y = _dot_mode(x, r.to(torch.float32), _mode(md))
        x = x + y if res else y
    outs = []
    if write_q:
        outs.append(a.copy_(x) if alias_q else x.to(out_dtype))
    if gram_mode is not None:
        gm = _mode(gram_mode)
        chunk = effective_chunk(m, n, chunk)
        nc = -(-m // chunk)
        if nc * chunk != m:  # zero rows add nothing to the Gram
            x = torch.cat([x, x.new_zeros(nc * chunk - m, n)])
        xs = x.view(nc, chunk, n)
        g = x.new_zeros(n, n)
        comp = x.new_zeros(n, n)
        for b0 in range(0, nc, _BLOCK_CHUNKS):
            contribs = _gram_half(xs[b0:b0 + _BLOCK_CHUNKS], gm)
            for contrib in contribs:
                y = contrib - comp
                t = g + y
                comp = (t - g) - y
                g = t
        outs.append(g)
    return tuple(outs) if len(outs) > 1 else outs[0]


def _lib():
    from tsqr_tpu_torch.ops import _build

    lib = _build.load("stream_gram", BUILD_DEFINES)
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.stream_gram_grid.argtypes = [cll, ci, ci, ci,
                                         ctypes.POINTER(ci)]
        lib.stream_gram_launch.argtypes = (
            [vp, ci, vp, vp, vp, ci] + [ci] * 6 + [vp, ci, ci, ci, vp, cll,
                                                   ci, ci, vp])
        lib.stream_gram_reduce.argtypes = [vp, vp, ci, ci, vp]
        for f in (lib.stream_gram_grid, lib.stream_gram_launch,
                  lib.stream_gram_reduce, lib.stream_gram_tile_rows,
                  lib.stream_gram_n_max):
            f.restype = ci
        if (lib.stream_gram_tile_rows() != TILE_ROWS
                or lib.stream_gram_n_max() != N_MAX):
            raise RuntimeError("stream_gram.cu and gram_stream.py disagree "
                               "on TILE_ROWS / N_MAX")
        lib._typed = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def grid_size(m: int, n: int, n_dots: int, gram_code: int) -> int:
    """CTAs of a launch (one float64 (n, n) partial Gram each);
    ``gram_code`` is -1 for no Gram."""
    g = ctypes.c_int(0)
    _raise_on(_lib().stream_gram_grid(m, n, n_dots, gram_code,
                                      ctypes.byref(g)), "stream_gram_grid")
    return g.value


def reduce_partials(partials: Tensor) -> Tensor:
    """Launch the reduction stage: sum the (grid, n, n) float64 partials
    over the grid in a fixed order, in float64, into a float32 (n, n)."""
    global REDUCE_LAUNCHES
    grid, n, _ = partials.shape
    out = torch.empty(n, n, dtype=torch.float32, device=partials.device)
    stream = torch.cuda.current_stream(partials.device).cuda_stream
    _raise_on(_lib().stream_gram_reduce(partials.data_ptr(), out.data_ptr(),
                                        grid, n * n, stream),
              "stream_gram_reduce")
    REDUCE_LAUNCHES += 1
    return out


def _stream_kernel(a: Tensor, rinvs, dot_ms, write_q, gram_m, out_dtype,
                   residual, alias_q=False):
    """Launch the CUDA kernel (and, for a Gram, its reduction stage);
    with ``alias_q`` the kernel writes Q over A."""
    global LAUNCHES, ALIAS_LAUNCHES
    m, n = a.shape
    if n > N_MAX:
        raise ValueError(f"the stream kernel takes n <= {N_MAX}, got {n}")
    if len(rinvs) > 3:
        raise ValueError("the stream kernel chains at most 3 dots")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the stream kernel reads float32 or bf16 A, got "
                         f"{a.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the stream kernel writes float32 or bf16 Q, got "
                         f"{out_dtype}")
    a = a.contiguous()
    rs = [r.to(device=a.device, dtype=torch.float32).contiguous()
          for r in rinvs]
    if any(r.shape != (n, n) for r in rs):
        raise ValueError("every rinv must be (n, n)")
    codes = [_kernel_code(md) for md in dot_ms] + [0] * (3 - len(rs))
    res = [int(b) for b in residual] + [0] * (3 - len(rs))
    ptrs = [r.data_ptr() for r in rs] + [None] * (3 - len(rs))
    if alias_q:
        q = a
    else:
        q = torch.empty(m, n, dtype=out_dtype, device=a.device) if write_q \
            else None
    gram_code = _kernel_code(gram_m) if gram_m is not None else -1
    grid = grid_size(m, n, len(rs), gram_code)
    partials = (torch.empty(grid, n, n, dtype=torch.float64, device=a.device)
                if gram_m is not None else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().stream_gram_launch(
        a.data_ptr(), int(a.dtype == torch.bfloat16), *ptrs, len(rs),
        *codes, *res, q.data_ptr() if write_q else None,
        int(out_dtype == torch.bfloat16), int(write_q), gram_code,
        partials.data_ptr() if partials is not None else None, m, n, grid,
        stream)
    _raise_on(err, "stream_gram_kernel launch")
    LAUNCHES += 1
    ALIAS_LAUNCHES += int(alias_q)
    outs = [q] if write_q else []
    if gram_m is not None:
        outs.append(reduce_partials(partials))
    return tuple(outs) if len(outs) > 1 else outs[0]


def stream(a: Tensor,
           rinvs: Sequence[Tensor] = (),
           dot_modes: Sequence[str] = (),
           write_q: bool = False,
           gram_mode: str | None = None,
           chunk: int = DEFAULT_CHUNK,
           out_dtype: torch.dtype | None = None,
           residual: Sequence[bool] = (),
           alias_q: bool = False):
    """One streaming pass over A: chained dots + optional fused half-Gram
    (the contract of ``stream_pallas``).

    For each row: x = A_row; x = x @ rinvs[i] at dot_modes[i] (x += x @
    rinvs[i] where residual[i], with rinvs[i] = Rinv - I); optionally Q =
    x in ``out_dtype``; optionally the half-Gram P of x at ``gram_mode``
    (the caller forms G = P + P^T).  Returns [Q] if write_q, + [P] if
    gram_mode, as a tuple in that order (a single element unpacked).

    ``alias_q=True`` writes Q into A's own storage and returns a tensor on
    it: the caller's A holds Q afterwards.  It requires ``write_q``,
    ``out_dtype == a.dtype`` and a contiguous A.  The result is bit for
    bit that of the call without it.

    A CUDA tensor goes through the CUDA kernel, which raises for what it
    does not take; a CPU tensor through :func:`stream_reference`."""
    residual = _check(a, rinvs, dot_modes, write_q, gram_mode, residual,
                      out_dtype, alias_q)
    if a.device.type == "cpu":
        return stream_reference(a, rinvs, dot_modes, write_q, gram_mode,
                                chunk, out_dtype, residual, alias_q)
    if a.device.type != "cuda":
        raise ValueError(f"stream runs on cuda or cpu, got {a.device}")
    if chunk != TILE_ROWS:
        raise ValueError(f"the stream kernel compensates every {TILE_ROWS} "
                         f"rows; got chunk={chunk}")
    dot_ms = [_mode(d) for d in dot_modes]
    gram_m = _mode(gram_mode) if gram_mode is not None else None
    return _stream_kernel(a, rinvs, dot_ms, write_q, gram_m,
                         out_dtype or a.dtype, residual, alias_q)


def gram_stream(a: Tensor, mode: str = "fp32",
                chunk: int = GRAM_CHUNK) -> Tensor:
    """G = A^T A in one read of A."""
    p = stream(a, gram_mode=modes.resolve(mode).mode.value, chunk=chunk)
    return p + p.T


def qpass_stream(a: Tensor, rinv: Tensor, mode: str = "fp32",
                 chunk: int = DEFAULT_CHUNK, with_gram: bool = True):
    """Q = A @ Rinv in float32, streamed; with ``with_gram`` also
    G = Q^T Q from the same pass.  Returns Q or (Q, G)."""
    mname = modes.resolve(mode).mode.value
    if with_gram:
        q, p = stream(a, (rinv,), (mname,), write_q=True, gram_mode=mname,
                      chunk=chunk, out_dtype=torch.float32)
        return q, p + p.T
    return stream(a, (rinv,), (mname,), write_q=True, chunk=chunk,
                  out_dtype=torch.float32)
