"""The streaming pass of the CholeskyQR pipelines: chained dots, an
optional Q write and an optional compensated half-Gram, in one read
of A.

Counterpart of ``tsqr_tpu/ops/pallas_gram.py``.  :func:`stream` launches
the CUDA kernels for a CUDA tensor and runs the plain PyTorch version
:func:`stream_reference` for a CPU tensor.  On a CUDA tensor it launches
a kernel or raises: there is no fallback.

Two kernels share the contract, by width:

* n <= ``N_MAX`` (128): ``csrc/stream_gram.cu``, one pass over A.  It
  reads A in tiles of ``TILE_ROWS`` rows and sums its Gram in float32
  over chunks of ``CHUNK_ROWS`` rows, adding each chunk into a float64
  sum.
* 128 < n <= ``WIDE_N_MAX`` (2048), in every mode: ``csrc/stream_wide.cu``,
  tiled kernels over row chunks: each dot, then the Gram of the result,
  which sums in float32 over slabs of ``WIDE_CHUNK_ROWS`` rows.  Which
  widths a pipeline streams at its mode is ``cholqr._fused_n_max``'s
  decision (the JAX package's range), not this module's.

Either takes any m; A float32 or bf16; up to three dots; modes fp32,
bf16, bf16_nocor, bf16x3_nocor, bf16x3_cor and bf16x6_cor.  ``stream``
takes ``chunk == CHUNK_ROWS`` on the card, and the plain version
compensates once per :func:`effective_chunk` rows, the kernel's own
granularity.  With ``alias_q`` it writes Q into A's own storage (no row
is written before every read of it), on either device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.utils import trace

Tensor = torch.Tensor

TILE_ROWS = 64          # rows of one tile of the kernel's ring
CHUNK_ROWS = 4096       # most rows the kernel sums before a compensated add
N_MAX = 128             # widest n the n <= 128 kernel takes
WIDE_N_MAX = 2048       # widest n the wide kernels take
WIDE_CHUNK_ROWS = 1024  # rows the wide Gram sums before a float64 add
DEFAULT_CHUNK = CHUNK_ROWS
GRAM_CHUNK = CHUNK_ROWS
_BLOCK_CHUNKS = 1024    # chunks whose Gram contributions the plain
                        # version forms in one batched product

# Preprocessor defines of the kernel build; harness/phase_profile.py sets
# ("STREAM_GRAM_PROFILE",) to compile the phase timers in.
BUILD_DEFINES: tuple[str, ...] = ()

# Kernel launches are counted where each kernel is launched, in the
# counters launches.<kernel> of utils/trace.py: stream_gram
# (stream_gram_kernel, and the stream_gram_split_r_kernel that a launch
# with dots runs first to split the factors), stream_gram_alias_q (the
# launches of either kernel that write Q over A), stream_gram_reduce, and
# the wide kernels' (a dot's, the Gram's and the store's once a row chunk;
# the factors' split once a call; x's split once a chunk and a product off
# fp32): stream_wide_dot, stream_wide_gram (the split modes),
# stream_wide_dot_fp32, stream_wide_gram_fp32, stream_wide_store (Q from a
# scratch x), stream_wide_split_r, stream_wide_split_x.
_WIDE_COUNTERS = ("stream_wide_dot", "stream_wide_gram", "stream_wide_store",
                  "stream_wide_split_r", "stream_wide_split_x",
                  "stream_wide_dot_fp32", "stream_wide_gram_fp32")

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
    axes): X^T X = P + P^T.  One product per residual order, as the
    kernel sums them: order 2 is x0^T x2 + x1^T (x1 / 2) stacked along
    the contraction, and the diagonal terms' 1/2 (a power of two, exact)
    sits in an operand; the orders are added smallest first.

    On the card each order's product over the chunk is formed in float64
    and rounded once to float32: there a float32 matmul over a 4096-row
    chunk lands 8.7e-6 off the exact Gram of the parts, low on the
    diagonal, where the kernel is within 3e-8 (an H100 80GB HBM3 at
    700 W, PERF.md), and the plain version is the reference the kernel is
    held to.  On the CPU the products are float32, as the JAX package's
    are."""
    xp, order = _mode_parts(x, md)
    wide = torch.float64 if x.is_cuda else x.dtype

    def t(u, v):
        return torch.matmul(u.transpose(-2, -1).to(wide),
                            v.to(wide)).to(torch.float32)

    if order == 0:
        return t(xp[0], 0.5 * xp[0])
    acc = None
    if order == 2:
        acc = t(torch.cat([xp[0], xp[1]], dim=-2),
                torch.cat([xp[2], 0.5 * xp[1]], dim=-2))
    b1 = t(xp[0], xp[1])
    acc = b1 if acc is None else acc + b1
    return acc + t(xp[0], 0.5 * xp[0])


def effective_chunk(m: int, n: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Rows summed in float32 before one compensated add of the Gram (the
    error budget of ``cholqr._shift_value_fused`` is ~sqrt(chunk) eps);
    on the card ``chunk`` is ``CHUNK_ROWS``, and past n = ``N_MAX`` the
    wide Gram's slab, ``WIDE_CHUNK_ROWS`` (the JAX package's own chunk at
    n = 1024)."""
    if n > N_MAX:
        chunk = min(chunk, WIDE_CHUNK_ROWS)
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
        lib.stream_gram_grid.argtypes = [cll] + [ci] * 6 + [
            ctypes.POINTER(ci)]
        lib.stream_gram_launch.argtypes = (
            [vp, ci, vp, vp, vp, ci] + [ci] * 6
            + [vp, vp, ci, ci, ci, ci, vp, cll, ci, ci, vp])
        lib.stream_gram_reduce.argtypes = [vp, vp, ci, ci, vp]
        for f in (lib.stream_gram_grid, lib.stream_gram_launch,
                  lib.stream_gram_reduce, lib.stream_gram_tile_rows,
                  lib.stream_gram_chunk_rows, lib.stream_gram_n_max,
                  lib.stream_gram_r_image_bytes):
            f.restype = ci
        if (lib.stream_gram_tile_rows() != TILE_ROWS
                or lib.stream_gram_chunk_rows() != CHUNK_ROWS
                or lib.stream_gram_n_max() != N_MAX):
            raise RuntimeError("stream_gram.cu and gram_stream.py disagree "
                               "on TILE_ROWS / CHUNK_ROWS / N_MAX")
        lib._typed = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def grid_size(m: int, n: int, dot_codes: Sequence[int] = (),
              gram_code: int = -1) -> int:
    """CTAs of a launch (kernel codes of the dots; ``gram_code`` -1 for
    no Gram).  Always even: the CTAs run in clusters of two, and a Gram
    launch's pair of CTAs shares one float64 (n, n) partial."""
    return _grid(m, n, tuple(dot_codes), gram_code,
                 torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _grid(m, n, dot_codes, gram_code, device):
    del device  # part of the key: the grid depends on the card
    codes = list(dot_codes) + [0] * (3 - len(dot_codes))
    g = ctypes.c_int(0)
    _raise_on(_lib().stream_gram_grid(m, n, len(dot_codes), *codes,
                                      gram_code, ctypes.byref(g)),
              "stream_gram_grid")
    return g.value


def reduce_partials(partials: Tensor) -> Tensor:
    """Launch the reduction stage: sum the (slabs, n, n) float64 partials
    over the slabs in a fixed order, in float64, into a float32 (n, n)."""
    slabs, n, _ = partials.shape
    out = torch.empty(n, n, dtype=torch.float32, device=partials.device)
    stream = torch.cuda.current_stream(partials.device).cuda_stream
    with trace.span("stream.launch"):
        err = _lib().stream_gram_reduce(partials.data_ptr(), out.data_ptr(),
                                        slabs, n * n, stream)
    _raise_on(err, "stream_gram_reduce")
    trace.count("launches.stream_gram_reduce")
    return out


def _launch_args(a: Tensor, rinvs, dot_ms, write_q, gram_m, out_dtype,
                 residual, alias_q):
    """What a launch of either kernel takes, checked: A contiguous, the
    float32 factors, their kernel codes, residual flags and pointers (three
    slots), Q (A itself with ``alias_q``) and the Gram's code (-1: none)."""
    m, n = a.shape
    if len(rinvs) > 3:
        raise ValueError("the stream kernels chain at most 3 dots")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the stream kernels read float32 or bf16 A, got "
                         f"{a.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the stream kernels write float32 or bf16 Q, got "
                         f"{out_dtype}")
    a = a.contiguous()
    rs = [r.to(device=a.device, dtype=torch.float32).contiguous()
          for r in rinvs]
    if any(r.shape != (n, n) for r in rs):
        raise ValueError("every rinv must be (n, n)")
    pad = [0] * (3 - len(rs))
    codes = [_kernel_code(md) for md in dot_ms] + pad
    res = [int(b) for b in residual] + pad
    ptrs = [r.data_ptr() for r in rs] + [None] * len(pad)
    if alias_q:
        q = a
    else:
        q = torch.empty(m, n, dtype=out_dtype, device=a.device) if write_q \
            else None
    gram_code = _kernel_code(gram_m) if gram_m is not None else -1
    return a, rs, codes, res, ptrs, q, gram_code


def _stream_kernel(a: Tensor, rinvs, dot_ms, write_q, gram_m, out_dtype,
                   residual, alias_q=False):
    """Launch the CUDA kernel (and, for a Gram, its reduction stage);
    with ``alias_q`` the kernel writes Q over A."""
    m, n = a.shape
    if n > N_MAX:
        raise ValueError(f"the stream kernel takes n <= {N_MAX}, got {n}")
    a, rs, codes, res, ptrs, q, gram_code = _launch_args(
        a, rinvs, dot_ms, write_q, gram_m, out_dtype, residual, alias_q)
    grid = grid_size(m, n, codes[:len(rs)], gram_code)
    partials = (torch.empty(grid // 2, n, n, dtype=torch.float64,
                            device=a.device)
                if gram_m is not None else None)
    # the factors' split images (stream_gram_split_r_kernel writes them)
    image = (torch.empty(len(rs) * _lib().stream_gram_r_image_bytes(),
                         dtype=torch.uint8, device=a.device) if rs else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with trace.span("stream.launch"):
        err = _lib().stream_gram_launch(
            a.data_ptr(), int(a.dtype == torch.bfloat16), *ptrs, len(rs),
            *codes, *res, image.data_ptr() if image is not None else None,
            q.data_ptr() if write_q else None,
            int(out_dtype == torch.bfloat16), int(write_q), int(alias_q),
            gram_code, partials.data_ptr() if partials is not None else None,
            m, n, grid, stream)
    _raise_on(err, "stream_gram_kernel launch")
    trace.count("launches.stream_gram")
    if alias_q:
        trace.count("launches.stream_gram_alias_q")
    outs = [q] if write_q else []
    if gram_m is not None:
        outs.append(reduce_partials(partials))
    return tuple(outs) if len(outs) > 1 else outs[0]


def _wide_lib():
    from tsqr_tpu_torch.ops import _build

    lib = _build.load("stream_wide")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.stream_wide_launch.argtypes = (
            [vp, ci, vp, vp, vp, ci] + [ci] * 6
            + [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, cll, ci, vp,
               ctypes.POINTER(ci)])
        lib.stream_wide_slabs.argtypes = [cll, ci]
        lib.stream_wide_chunk_rows.argtypes = [ci]
        lib.stream_wide_image_bytes.argtypes = [ci]
        lib.stream_wide_needs_scratch.argtypes = [ci] * 5
        lib.stream_wide_kpad.argtypes = [ci]
        for f in (lib.stream_wide_launch, lib.stream_wide_slabs,
                  lib.stream_wide_needs_scratch, lib.stream_wide_n_max,
                  lib.stream_wide_slab_rows, lib.stream_wide_kpad):
            f.restype = ci
        lib.stream_wide_chunk_rows.restype = cll
        lib.stream_wide_image_bytes.restype = cll
        if (lib.stream_wide_n_max() != WIDE_N_MAX
                or lib.stream_wide_slab_rows() != WIDE_CHUNK_ROWS):
            raise RuntimeError("stream_wide.cu and gram_stream.py disagree "
                               "on WIDE_N_MAX / WIDE_CHUNK_ROWS")
        lib._typed = True
    return lib


def _stream_wide(a: Tensor, rinvs, dot_ms, write_q, gram_m, out_dtype,
                 residual, alias_q=False):
    """Launch the wide kernels (``csrc/stream_wide.cu``) over A's row
    chunks, then, for a Gram, the reduction stage over its partials."""
    m, n = a.shape
    if not N_MAX < n <= WIDE_N_MAX:
        raise ValueError(f"the wide stream kernels take {N_MAX} < n <= "
                         f"{WIDE_N_MAX}, got {n}")
    a, rs, codes, res, ptrs, q, gram_code = _launch_args(
        a, rinvs, dot_ms, write_q, gram_m, out_dtype, residual, alias_q)
    lib = _wide_lib()
    q_bf16 = int(out_dtype == torch.bfloat16)
    dev = a.device
    partials = (torch.empty(lib.stream_wide_slabs(m, n), n, n,
                            dtype=torch.float64, device=dev)
                if gram_m is not None else None)
    image = (torch.empty(len(rs) * lib.stream_wide_image_bytes(n),
                         dtype=torch.uint8, device=dev) if rs else None)
    rows = min(m, lib.stream_wide_chunk_rows(n))
    scratch = [None, None]
    if lib.stream_wide_needs_scratch(len(rs), int(write_q), int(alias_q),
                                     gram_code, q_bf16):
        scratch = list(torch.empty(2, rows, n, dtype=torch.float32,
                                   device=dev))
    # x's bf16 parts, a chunk's rows (the split products' operand)
    parts = (torch.empty(3, rows, lib.stream_wide_kpad(n),
                         dtype=torch.bfloat16, device=dev)
             if max(codes[:len(rs)] + [gram_code]) > 0 else None)
    launches = (ctypes.c_int * len(_WIDE_COUNTERS))()
    with trace.span("stream.launch"):
        err = lib.stream_wide_launch(
            a.data_ptr(), int(a.dtype == torch.bfloat16), *ptrs, len(rs),
            *codes, *res, image.data_ptr() if image is not None else None,
            q.data_ptr() if write_q else None, q_bf16, int(write_q),
            int(alias_q), gram_code,
            partials.data_ptr() if partials is not None else None,
            *(s.data_ptr() if s is not None else None for s in scratch),
            parts.data_ptr() if parts is not None else None,
            m, n, torch.cuda.current_stream(dev).cuda_stream, launches)
    for name, k in zip(_WIDE_COUNTERS, launches):
        if k:
            trace.count("launches." + name, k)
    _raise_on(err, "stream_wide launch")
    if alias_q:
        trace.count("launches.stream_gram_alias_q")
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

    n <= ``N_MAX`` runs the one-pass kernel, 128 < n <= ``WIDE_N_MAX``
    the wide kernels, in every mode; a wider n raises on either device.
    A CUDA tensor goes through the CUDA kernels, which raise for what they
    do not take; a CPU tensor through :func:`stream_reference`."""
    with trace.span("stream"):
        residual = _check(a, rinvs, dot_modes, write_q, gram_mode, residual,
                          out_dtype, alias_q)
        if a.shape[1] > WIDE_N_MAX:
            raise ValueError(f"the stream kernels take n <= {WIDE_N_MAX}, "
                             f"got n={a.shape[1]}")
        if a.device.type == "cpu":
            return stream_reference(a, rinvs, dot_modes, write_q, gram_mode,
                                    chunk, out_dtype, residual, alias_q)
        if a.device.type != "cuda":
            raise ValueError(f"stream runs on cuda or cpu, got {a.device}")
        if chunk != CHUNK_ROWS:
            raise ValueError(f"the stream kernel compensates every "
                             f"{CHUNK_ROWS} rows; got chunk={chunk}")
        dot_ms = [_mode(d) for d in dot_modes]
        gram_m = _mode(gram_mode) if gram_mode is not None else None
        launch = _stream_kernel if a.shape[1] <= N_MAX else _stream_wide
        return launch(a, rinvs, dot_ms, write_q, gram_m,
                      out_dtype or a.dtype, residual, alias_q)


def gram_stream(a: Tensor, mode: str = "fp32",
                chunk: int = GRAM_CHUNK) -> Tensor:
    """G = A^T A in one read of A."""
    with trace.span("stream"):
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
