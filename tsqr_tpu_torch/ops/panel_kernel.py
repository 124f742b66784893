"""Batched Householder panel QR of (L, n) tiles: the TSQR tree's leaf.

Counterpart of ``tsqr_tpu/ops/pallas_panel_sb.py::panel_qr_pallas_sb``
and ``tsqr_tpu/ops/pallas_panel.py::panel_qr_pallas``: (B, L, n) float32
-> (Q^T (B, n, L), R (B, n, n)), Q returned transposed per tile.
:func:`panel_qr_batched` launches a CUDA kernel for a CUDA tensor and
runs the plain PyTorch version :func:`panel_qr_reference` for a CPU
tensor.  On a CUDA tensor it launches the kernel or raises: there is no
fallback.  Two kernels, by width:

* n <= ``N_MAX`` (128): ``csrc/panel_qr.cu``, the tile resident in one
  CTA's shared memory; n <= L <= :func:`max_leaf_rows` (what that
  memory holds, and at most ``L_MAX``: two rows a thread in the column
  chain).  A launch too small to fill the card spreads each tile over a
  cluster of :func:`cluster_size` CTAs, each holding some of its W-Y
  blocks, with the same outputs bit for bit.  Launches counted in the
  counter ``launches.panel_qr`` (``utils/trace.py``), those on clusters
  also in ``panel_qr.cluster_launches``.
* ``N_MAX`` < n <= ``WIDE_N_MAX`` (512, the JAX kernel's edge):
  ``csrc/panel_wide.cu``, the tile in device memory, factored one
  16-column block at a time and updated one ``PANEL`` (64) columns at a
  time; n <= L <= ``L_WIDE_MAX`` (four rows a thread in the column
  chain).  Calls counted in ``launches.panel_qr_wide``, each
  :func:`wide_kernel_launches` kernel launches, of which
  :func:`wide_outer_applies` are 64-column applies (counted in
  ``panel_wide.outer_applies``).

Both run W-Y blocks of ``BLOCK`` (16) columns in the modes fp32, bf16,
bf16_nocor, bf16x3_nocor, bf16x3_cor and bf16x6_cor.  :func:`leaf_rows`
is the tree's leaf height on them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.ops import gram_stream
from tsqr_tpu_torch.utils import trace

Tensor = torch.Tensor
_dot_mode = gram_stream._dot_mode  # a product at a mode, split as B1's

N_MAX = 128            # widest n of panel_qr.cu
WIDE_N_MAX = 512       # widest n of panel_wide.cu
L_WIDE_MAX = 1024      # most rows of panel_wide.cu: four a thread
WIDE_ROW_PAD = 16      # panel_wide.cu pads its work tile's rows to this
BLOCK = 16             # columns per W-Y block
PANEL = 64             # columns per panel of panel_wide.cu: four blocks
_YS_ROW = 384          # bytes a row of panel_wide.cu's split panel Y
_THREADS = 256
L_MAX = 2 * _THREADS   # most rows: two a thread in the column chain
_SMEM_MAX = 232448     # dynamic shared memory a block may use on sm_90
_YS = 24               # bf16 a row of a Y part in shared memory
CLUSTER_SIZES = (8, 4, 2)  # CTAs a tile on panel_qr.cu's cluster path

# Preprocessor defines of the kernel build; harness/phase_profile.py sets
# ("PANEL_QR_PROFILE",) to compile the phase timers in.
BUILD_DEFINES: tuple[str, ...] = ()


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


def cluster_smem_bytes(L: int, n: int, k: int) -> int:
    """Dynamic shared memory of a CTA of an (L, n) tile's cluster of k
    (``cluster_layout`` in ``panel_qr.cu``), sized for the CTA holding the
    most W-Y blocks, b = ceil(ceil(n / 16) / k): their float32 columns,
    their published reflectors (float32, 16 a row), the applied block's Y
    in bf16 parts, W's parts and Y^T X over its columns, every block's T,
    and the column chain's buffers as in :func:`smem_bytes`."""
    nblk = -(-n // BLOCK)
    ncl = -(-nblk // k) * BLOCK
    lp = -(-L // 16) * 16
    sl = -(-L // 32) * 32 + 8
    return (ncl * sl * 4 + ncl * lp * 4 + 3 * lp * _YS * 2
            + 3 * BLOCK * (ncl + 8) * 2 + BLOCK * ncl * 4
            + nblk * BLOCK * BLOCK * 4 + BLOCK * BLOCK * 4 + nblk * BLOCK * 4
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


def cluster_size(batch: int, L: int, n: int, max_clusters) -> int:
    """The CTAs each tile of a (batch, L, n) launch of ``panel_qr.cu``
    runs on: the largest k of ``CLUSTER_SIZES``, at most the tile's W-Y
    blocks (ceil(n / ``BLOCK``)), such that the card runs ``batch``
    clusters of k at once (``max_clusters(k, L, n)`` of them), else 1, a
    CTA a tile, as a launch of a wave or more runs.  Reads only its
    arguments."""
    blocks = -(-n // BLOCK)
    for k in CLUSTER_SIZES:
        if k <= blocks and batch <= max_clusters(k, L, n):
            return k
    return 1


def leaf_rows(n: int) -> int:
    """The tree's leaf height on the panel kernels at width n, each
    kernel's tallest tile (fewer leaves, fewer eager inner nodes):
    :func:`max_leaf_rows` for n <= ``N_MAX``, ``L_WIDE_MAX`` up to
    ``WIDE_N_MAX``."""
    if n <= N_MAX:
        return max_leaf_rows(n)
    if n > WIDE_N_MAX:
        raise ValueError(f"the panel kernels take 1 <= n <= {WIDE_N_MAX}, "
                         f"got {n}")
    return L_WIDE_MAX


def wide_kernel_launches(n: int) -> int:
    """Kernel launches of one wide call at width n: the load; a chain a
    block and, but for each panel's last block, its update of the panel's
    later columns; a panel's Y and T and its update of the columns right
    of it, but for the last panel; R; a panel's Y and its Q update a panel
    of the Q build."""
    return 2 * -(-n // BLOCK) + 3 * -(-n // PANEL)


def wide_outer_applies(n: int) -> int:
    """The 64-column applies of one wide call at width n: the trailing
    updates of every panel but the last, and the Q build's, a panel
    each."""
    return 2 * -(-n // PANEL) - 1


def _check(a: Tensor) -> None:
    if a.dim() != 3:
        raise ValueError(f"panel QR wants a (B, L, n) batch, got shape "
                         f"{tuple(a.shape)}")
    if a.shape[1] < a.shape[2]:
        raise ValueError(f"panel QR wants tall tiles, got {tuple(a.shape)}")


def _update(x: Tensor, y: Tensor, t: Tensor, lo: int, hi: int,
            md) -> None:
    """X[:, :, lo:hi] -= Y (T^T (Y^T X)), the products at the mode, W = T^T
    (Y^T X) in float32."""
    rest = x[:, :, lo:hi]
    w = torch.matmul(t.transpose(1, 2), _dot_mode(y.transpose(1, 2), rest,
                                                  md))
    x[:, :, lo:hi] = rest - _dot_mode(y, w, md)


def _merge_t(y: Tensor, ts: list[Tensor]) -> Tensor:
    """The T of a panel from its blocks' T, a block b at a time:
    Z = (Y_{<b}^T Y_b) T_b, T[:s, b] = -T[:s, :s] Z, all in float32."""
    width = sum(t.shape[-1] for t in ts)
    g = torch.matmul(y.transpose(1, 2), y)
    out = y.new_zeros(y.shape[0], width, width)
    s = 0
    for tb in ts:
        nb = tb.shape[-1]
        out[:, s:s + nb, s:s + nb] = tb
        if s:
            z = torch.matmul(g[:, :s, s:s + nb], tb)
            out[:, :s, s:s + nb] = -torch.matmul(out[:, :s, :s], z)
        s += nb
    return out


def _chain(x: Tensor, y_all: Tensor, c0: int, nb: int) -> Tensor:
    """The column chain of the block of columns c0 .. c0 + nb, in float32:
    each reflector applied to the block's later columns, R's entries and
    the reflectors (into ``y_all``) written, the block's T returned."""
    B, L, _ = x.shape
    rows = torch.arange(L, device=x.device)
    t = torch.zeros(B, nb, nb, dtype=torch.float32, device=x.device)
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
        # the dots D_c of the column with the block's columns (rows >= j);
        # v's dot with column c is D_c + sign ||x|| x_jc, as the kernel
        # forms it from one reduction a column
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
    return t


def panel_qr_reference(a: Tensor, mode="fp32",
                       block: int = BLOCK) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernels, on A's device, batched over
    the tiles: the same compact-WY algorithm (B3's), the same float32
    column work and the same block products at the mode, blocked as each
    kernel blocks.  For n <= ``N_MAX`` (``panel_qr.cu``) each block
    updates every column right of it and the Q build runs by blocks.
    Past it (``panel_wide.cu``) the blocks group into panels of
    ``PANEL`` columns: a block updates only its panel's later columns,
    the panel's T is merged from its blocks' (:func:`_merge_t`) and the
    panel updates the columns right of it in one product, and the Q
    build runs by panels.  Returns (Q^T (B, n, L), R (B, n, n)) in
    float32."""
    _check(a)
    md = gram_stream._mode(mode)
    B, L, n = a.shape
    x = a.to(torch.float32).clone()
    y_all = torch.zeros(B, L, n, dtype=torch.float32, device=x.device)
    width = PANEL if n > N_MAX else n
    units = []  # (first column, T) of the Q build's reflectors
    for p0 in range(0, n, width):
        p1 = min(p0 + width, n)
        ts = []
        for c0 in range(p0, p1, block):
            nb = min(block, p1 - c0)
            ts.append(_chain(x, y_all, c0, nb))
            if c0 + nb < p1:  # the block's update of its panel's columns
                _update(x, y_all[:, :, c0:c0 + nb], ts[-1], c0 + nb, p1, md)
        if width == n:
            units.extend(zip(range(p0, p1, block), ts))
            continue
        t = _merge_t(y_all[:, :, p0:p1], ts)
        units.append((p0, t))
        if p1 < n:  # the panel's update of the columns right of it
            _update(x, y_all[:, :, p0:p1], t, p1, n, md)
    r = torch.triu(x[:, :n, :])
    q = torch.eye(L, n, dtype=torch.float32, device=x.device).expand(B, L, n)
    for c0, t in reversed(units):  # Q -= Y (T (Y^T Q))
        yb = y_all[:, :, c0:c0 + t.shape[-1]]
        w = _dot_mode(yb.transpose(1, 2), q, md)
        q = q - _dot_mode(yb, torch.matmul(t, w), md)
    return q.transpose(1, 2).contiguous(), r


def _lib():
    from tsqr_tpu_torch.ops import _build

    lib = _build.load("panel_qr", BUILD_DEFINES)
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.panel_qr_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.panel_qr_launch.restype = ci
        lib.panel_qr_smem_bytes.argtypes = [ci, ci]
        lib.panel_qr_cluster_smem_bytes.argtypes = [ci, ci, ci]
        lib.panel_qr_cluster_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci,
                                                ci, vp]
        lib.panel_qr_cluster_launch.restype = ci
        lib.panel_qr_max_clusters.argtypes = [ci, ci, ci, ci,
                                              ctypes.POINTER(ci)]
        lib.panel_qr_max_clusters.restype = ci
        for f in (lib.panel_qr_smem_bytes, lib.panel_qr_smem_max,
                  lib.panel_qr_cluster_smem_bytes):
            f.restype = cll
        for f in (lib.panel_qr_n_max, lib.panel_qr_l_max, lib.panel_qr_block):
            f.restype = ci
        if (lib.panel_qr_n_max() != N_MAX or lib.panel_qr_block() != BLOCK
                or lib.panel_qr_l_max() != L_MAX
                or lib.panel_qr_smem_max() != _SMEM_MAX
                or any(lib.panel_qr_smem_bytes(L, n) != smem_bytes(L, n)
                       for L, n in ((256, 128), (200, 50), (512, 64)))
                or any(lib.panel_qr_cluster_smem_bytes(L, n, k)
                       != cluster_smem_bytes(L, n, k)
                       for L, n, k in ((256, 128, 8), (288, 128, 2),
                                       (512, 50, 4)))):
            raise RuntimeError("panel_qr.cu and panel_kernel.py disagree on "
                               "N_MAX / L_MAX / BLOCK / the shared-memory "
                               "layouts")
        lib._typed = True
    return lib


def _wide_lib():
    from tsqr_tpu_torch.ops import _build

    lib = _build.load("panel_wide")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.panel_wide_launch.argtypes = ([vp] * 9 + [ci, ci, ci, ci]
                                          + [ctypes.POINTER(ci), vp])
        lib.panel_wide_launch.restype = ci
        for f in (lib.panel_wide_n_max, lib.panel_wide_l_max,
                  lib.panel_wide_block, lib.panel_wide_panel,
                  lib.panel_wide_row_pad, lib.panel_wide_ys_row_bytes):
            f.restype = ci
        if (lib.panel_wide_n_max() != WIDE_N_MAX
                or lib.panel_wide_l_max() != L_WIDE_MAX
                or lib.panel_wide_block() != BLOCK
                or lib.panel_wide_panel() != PANEL
                or lib.panel_wide_row_pad() != WIDE_ROW_PAD
                or lib.panel_wide_ys_row_bytes() != _YS_ROW):
            raise RuntimeError("panel_wide.cu and panel_kernel.py disagree "
                               "on WIDE_N_MAX / L_WIDE_MAX / BLOCK / PANEL / "
                               "the row padding / the split Y's rows")
        lib._typed = True
    return lib


def _wide_kernel(a: Tensor, md: modes.ComputeMode) -> tuple[Tensor, Tensor]:
    """Launch the wide kernel's sequence on a (B, L, n) float32 batch,
    ``N_MAX`` < n <= ``WIDE_N_MAX``: the work tile, the reflectors'
    diagonals, the blocks' and the panels' T and one panel's split Y are
    scratch of the call."""
    B, L, n = a.shape
    if L > L_WIDE_MAX:
        raise ValueError(f"the wide panel kernel takes L <= {L_WIDE_MAX} "
                         f"rows at n={n}, got L={L}")
    a = a.contiguous()
    lp = -(-L // WIDE_ROW_PAD) * WIDE_ROW_PAD
    nblk, npan = -(-n // BLOCK), -(-n // PANEL)

    def empty(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=a.device)
    qt, r, x = empty(B, n, L), empty(B, n, n), empty(B, n, lp)
    qw = qt if lp == L else empty(B, n, lp)
    vd, tm = empty(B, nblk * BLOCK), empty(B, nblk, BLOCK, BLOCK)
    ys, t64 = empty(B, lp, _YS_ROW // 4), empty(B, npan, PANEL, PANEL)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    issued = (ctypes.c_int * 2)()
    err = _wide_lib().panel_wide_launch(
        a.data_ptr(), qt.data_ptr(), r.data_ptr(), x.data_ptr(),
        qw.data_ptr(), vd.data_ptr(), tm.data_ptr(), ys.data_ptr(),
        t64.data_ptr(), B, L, n, gram_stream._kernel_code(md), issued,
        stream)
    gram_stream._raise_on(err, "panel_wide launch")
    trace.count("launches.panel_qr_wide")
    trace.count("panel_wide.outer_applies", issued[1])
    if (issued[0], issued[1]) != (wide_kernel_launches(n),
                                  wide_outer_applies(n)):
        raise RuntimeError(f"panel_wide.cu launched {issued[0]} kernels, "
                           f"{issued[1]} of them 64-column applies, at "
                           f"n={n}; panel_kernel.py counts "
                           f"{wide_kernel_launches(n)} and "
                           f"{wide_outer_applies(n)}")
    return qt, r


@functools.lru_cache(maxsize=None)
def _max_clusters(code: int, k: int, L: int, n: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster kernel for a mode
    code, k, L and n (its shared memory): asked once, then cached."""
    got = ctypes.c_int()
    err = _lib().panel_qr_max_clusters(L, n, code, k, ctypes.byref(got))
    gram_stream._raise_on(err, "panel_qr_max_clusters")
    return got.value


@functools.lru_cache(maxsize=4096)
def _launch_cluster_size(batch: int, L: int, n: int, code: int) -> int:
    return cluster_size(batch, L, n, functools.partial(_max_clusters, code))


def _panel_kernel(a: Tensor, md: modes.ComputeMode,
                  k: int | None = None) -> tuple[Tensor, Tensor, int]:
    """Launch the CUDA kernel on a (B, L, n) float32 batch, each tile of
    ``panel_qr.cu`` over a cluster of k CTAs (:func:`cluster_size`'s k
    where k is None; 1 on ``panel_wide.cu``).  Returns (Q^T, R, k)."""
    B, L, n = a.shape
    if n > WIDE_N_MAX:
        raise ValueError(f"the panel kernels take n <= {WIDE_N_MAX}, got "
                         f"{n}")
    if a.dtype != torch.float32:
        raise ValueError(f"the panel kernel reads float32 tiles, got "
                         f"{a.dtype}")
    if n > N_MAX:
        return (*_wide_kernel(a, md), 1)
    if L > max_leaf_rows(n):  # also L <= L_MAX
        raise ValueError(f"the panel kernel holds L <= {max_leaf_rows(n)} "
                         f"rows at n={n} in shared memory, got L={L}")
    code = gram_stream._kernel_code(md)
    if k is None:
        k = _launch_cluster_size(B, L, n, code)
    a = a.contiguous()
    qt = torch.empty(B, n, L, dtype=torch.float32, device=a.device)
    r = torch.empty(B, n, n, dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if k == 1:
        err = _lib().panel_qr_launch(a.data_ptr(), qt.data_ptr(),
                                     r.data_ptr(), B, L, n, code, stream)
    else:
        err = _lib().panel_qr_cluster_launch(a.data_ptr(), qt.data_ptr(),
                                             r.data_ptr(), B, L, n, code, k,
                                             stream)
    gram_stream._raise_on(err, "panel_qr_kernel launch" if k == 1
                          else f"panel_qr_cluster_kernel launch (k={k})")
    trace.count("launches.panel_qr")
    if k > 1:
        trace.count("panel_qr.cluster_launches")
    return qt, r, k


def panel_qr_batched(a: Tensor, mode="fp32") -> tuple[Tensor, Tensor]:
    """Householder QR of each (L, n) tile of a (B, L, n) batch: returns
    (Q^T (B, n, L), R (B, n, n)) in float32, R upper-triangular with
    exact zeros below, diag(R)_j = -sign(x_j) ||x|| (sign(0) = +1), in
    W-Y blocks of ``BLOCK`` columns.

    A CUDA tensor goes through a CUDA kernel (``panel_qr.cu`` for
    n <= ``N_MAX``, ``panel_wide.cu`` up to ``WIDE_N_MAX``), which raises
    for the shapes it does not take; a CPU tensor through
    :func:`panel_qr_reference`.  Each call is a ``panel`` span
    (``utils/trace.py``), its attr cluster the CTAs a tile ran on."""
    _check(a)
    md = gram_stream._mode(mode)
    B, L, n = a.shape
    with trace.span("panel", kernel="panel_qr" if n <= N_MAX
                    else "panel_wide", batch=B, L=L, n=n, cluster=1) as sp:
        if a.device.type == "cpu":
            return panel_qr_reference(a, md.value)
        if a.device.type != "cuda":
            raise ValueError(f"panel QR runs on cuda or cpu, got {a.device}")
        qt, r, k = _panel_kernel(a.to(torch.float32), md)
        sp.set(cluster=k)
        return qt, r
