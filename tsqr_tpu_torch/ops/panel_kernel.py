"""Batched Householder panel QR of (L, n) tiles: the TSQR tree's leaf.

Counterpart of ``tsqr_tpu/ops/pallas_panel_sb.py::panel_qr_pallas_sb``
and ``tsqr_tpu/ops/pallas_panel.py::panel_qr_pallas``: (B, L, n) float32
-> (Q^T (B, n, L), R (B, n, n)), Q returned transposed per tile.
:func:`panel_qr_batched` launches the CUDA kernel ``csrc/panel_qr.cu``
for a CUDA tensor and runs the plain PyTorch version
:func:`panel_qr_reference` for a CPU tensor.  On a CUDA tensor it
launches the kernel or raises: there is no fallback.

The kernel's shapes: n <= ``N_MAX`` (128), n <= L <= :func:`max_leaf_rows`
(what one block's shared memory holds, and at most ``L_MAX``: two rows a
thread in the column chain), W-Y blocks of ``BLOCK`` (16) columns; modes fp32, bf16, bf16_nocor, bf16x3_nocor, bf16x3_cor and
bf16x6_cor.
"""

from __future__ import annotations

import ctypes

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.ops import gram_stream

Tensor = torch.Tensor
_dot_mode = gram_stream._dot_mode  # a product at a mode, split as B1's

N_MAX = 128            # widest n
BLOCK = 16             # columns per W-Y block
_THREADS = 256
L_MAX = 2 * _THREADS   # most rows: two a thread in the column chain
_SMEM_MAX = 232448     # dynamic shared memory a block may use on sm_90
_YS = 24               # bf16 a row of a Y part in shared memory

# Preprocessor defines of the kernel build; harness/phase_profile.py sets
# ("PANEL_QR_PROFILE",) to compile the phase timers in.
BUILD_DEFINES: tuple[str, ...] = ()

# Kernel launches, counted where the kernel is launched.
LAUNCHES = 0


def smem_bytes(L: int, n: int) -> int:
    """Dynamic shared memory of one (L, n) tile's CTA (``layout`` in
    ``panel_qr.cu``): the column-major float32 tile (columns padded to a
    multiple of 16, row stride round_up(L, 32) + 8), one block's Y in
    three bf16 parts (rows padded to a multiple of 16, 24 bf16 a row),
    W's parts, Y^T X, every block's T, the block's Y^T v, the
    reflectors' diagonal and the column chain's double-buffered warp
    partials and pivot row."""
    ncp = -(-n // BLOCK) * BLOCK
    lp = -(-L // 16) * 16
    sl = -(-L // 32) * 32 + 8
    return (ncp * sl * 4 + 3 * lp * _YS * 2 + 3 * BLOCK * (ncp + 8) * 2
            + BLOCK * ncp * 4 + ncp * BLOCK * 4 + BLOCK * BLOCK * 4 + ncp * 4
            + 2 * (_THREADS // 32) * BLOCK * 4 + 2 * BLOCK * 4)


def max_leaf_rows(n: int) -> int:
    """The largest L, a multiple of 8 and at most ``L_MAX``, whose (L, n)
    tile the kernel's shared memory holds (288 at n = 128, 512 at
    n = 64)."""
    if not 1 <= n <= N_MAX:
        raise ValueError(f"the panel kernel takes 1 <= n <= {N_MAX}, got {n}")
    L = L_MAX
    while smem_bytes(L, n) > _SMEM_MAX:
        L -= 8
    return L


def _check(a: Tensor) -> None:
    if a.dim() != 3:
        raise ValueError(f"panel QR wants a (B, L, n) batch, got shape "
                         f"{tuple(a.shape)}")
    if a.shape[1] < a.shape[2]:
        raise ValueError(f"panel QR wants tall tiles, got {tuple(a.shape)}")


def panel_qr_reference(a: Tensor, mode="fp32",
                       block: int = BLOCK) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel, on A's device, batched over
    the tiles: the same compact-WY algorithm (B3's), the same float32
    column work and the same block products at the mode.  Returns
    (Q^T (B, n, L), R (B, n, n)) in float32."""
    _check(a)
    md = gram_stream._mode(mode)
    B, L, n = a.shape
    x = a.to(torch.float32).clone()
    dev = x.device
    rows = torch.arange(L, device=dev)
    y_all = torch.zeros(B, L, n, dtype=torch.float32, device=dev)
    ts = []
    for c0 in range(0, n, block):
        nb = min(block, n - c0)
        t = torch.zeros(B, nb, nb, dtype=torch.float32, device=dev)
        for k in range(nb):
            j = c0 + k
            col = torch.where(rows >= j, x[:, :, j], 0.0)
            norm2 = torch.sum(col * col, dim=1)
            norm = torch.sqrt(norm2)
            xj = x[:, j, j]
            sign = torch.where(xj >= 0, 1.0, -1.0)
            vnorm2 = norm2 + 2.0 * sign * norm * xj + norm2
            beta = torch.where(vnorm2 > 1e-30, 2.0 / vnorm2,
                               torch.zeros_like(vnorm2))
            sn = sign * norm
            v = col.clone()
            v[:, j] = xj + sn
            # the dots D_c of the column with the block's columns (rows
            # >= j); v's dot with column c is D_c + sign ||x|| x_jc, as the
            # kernel forms it from one reduction a column
            blk = x[:, :, c0:c0 + nb]
            vdot = (torch.einsum("bi,bic->bc", col, blk)
                    + sn[:, None] * x[:, j, c0:c0 + nb])
            if j + 1 < c0 + nb:  # rank-1 update of the block's later columns
                w = vdot[:, k + 1:]
                x[:, :, j + 1:c0 + nb] = x[:, :, j + 1:c0 + nb] - (
                    beta[:, None] * w)[:, None] * v[:, :, None]
            if k > 0:  # T[:k, k] = -beta T[:k, :k] (Y^T v)
                t[:, :k, k] = -beta[:, None] * torch.einsum(
                    "bqp,bp->bq", t[:, :k, :k], vdot[:, :k])
            t[:, k, k] = beta
            y_all[:, :, j] = v
            x[:, j, j] = -sign * norm
        ts.append(t)
        if c0 + nb < n:  # trailing update X -= Y (T^T (Y^T X))
            yb = y_all[:, :, c0:c0 + nb]
            rest = x[:, :, c0 + nb:]
            p = _dot_mode(yb.transpose(1, 2), rest, md)
            w2 = torch.matmul(t.transpose(1, 2), p)
            x[:, :, c0 + nb:] = rest - _dot_mode(yb, w2, md)
    r = torch.triu(x[:, :n, :])
    q = torch.eye(L, n, dtype=torch.float32, device=dev).expand(B, L, n)
    for bi in reversed(range(len(ts))):  # Q -= Y (T (Y^T Q))
        c0 = bi * block
        yb = y_all[:, :, c0:c0 + ts[bi].shape[-1]]
        w = _dot_mode(yb.transpose(1, 2), q, md)
        q = q - _dot_mode(yb, torch.matmul(ts[bi], w), md)
    return q.transpose(1, 2).contiguous(), r


def _lib():
    from tsqr_tpu_torch.ops import _build

    lib = _build.load("panel_qr", BUILD_DEFINES)
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.panel_qr_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.panel_qr_launch.restype = ci
        lib.panel_qr_smem_bytes.argtypes = [ci, ci]
        for f in (lib.panel_qr_smem_bytes, lib.panel_qr_smem_max):
            f.restype = cll
        for f in (lib.panel_qr_n_max, lib.panel_qr_l_max, lib.panel_qr_block):
            f.restype = ci
        if (lib.panel_qr_n_max() != N_MAX or lib.panel_qr_block() != BLOCK
                or lib.panel_qr_l_max() != L_MAX
                or lib.panel_qr_smem_max() != _SMEM_MAX
                or any(lib.panel_qr_smem_bytes(L, n) != smem_bytes(L, n)
                       for L, n in ((256, 128), (200, 50), (512, 64)))):
            raise RuntimeError("panel_qr.cu and panel_kernel.py disagree on "
                               "N_MAX / L_MAX / BLOCK / the shared-memory "
                               "layout")
        lib._typed = True
    return lib


def _panel_kernel(a: Tensor, md: modes.ComputeMode) -> tuple[Tensor, Tensor]:
    """Launch the CUDA kernel on a (B, L, n) float32 batch."""
    global LAUNCHES
    B, L, n = a.shape
    if n > N_MAX:
        raise ValueError(f"the panel kernel takes n <= {N_MAX}, got {n}")
    if L > max_leaf_rows(n):  # also L <= L_MAX
        raise ValueError(f"the panel kernel holds L <= {max_leaf_rows(n)} "
                         f"rows at n={n} in shared memory, got L={L}")
    if a.dtype != torch.float32:
        raise ValueError(f"the panel kernel reads float32 tiles, got "
                         f"{a.dtype}")
    a = a.contiguous()
    qt = torch.empty(B, n, L, dtype=torch.float32, device=a.device)
    r = torch.empty(B, n, n, dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().panel_qr_launch(a.data_ptr(), qt.data_ptr(), r.data_ptr(),
                                 B, L, n, gram_stream._kernel_code(md), stream)
    gram_stream._raise_on(err, "panel_qr_kernel launch")
    LAUNCHES += 1
    return qt, r


def panel_qr_batched(a: Tensor, mode="fp32") -> tuple[Tensor, Tensor]:
    """Householder QR of each (L, n) tile of a (B, L, n) batch: returns
    (Q^T (B, n, L), R (B, n, n)) in float32, R upper-triangular with
    exact zeros below, diag(R)_j = -sign(x_j) ||x|| (sign(0) = +1), in
    W-Y blocks of ``BLOCK`` columns.

    A CUDA tensor goes through the CUDA kernel, which raises for the
    shapes it does not take; a CPU tensor through
    :func:`panel_qr_reference`."""
    _check(a)
    md = gram_stream._mode(mode)
    if a.device.type == "cpu":
        return panel_qr_reference(a, md.value)
    if a.device.type != "cuda":
        raise ValueError(f"panel QR runs on cuda or cpu, got {a.device}")
    return _panel_kernel(a.to(torch.float32), md)
