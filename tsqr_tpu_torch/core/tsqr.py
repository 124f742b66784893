"""TSQR: communication-avoiding tall-skinny QR over a reduction tree.

Counterpart of ``tsqr_tpu/core/tsqr.py``.  The leaves are equal,
8-row-aligned tiles of the zero-padded input, factored in one batched
call; their R factors are stacked ``fanin`` at a time and factored again
up to the root; Q is rebuilt down the tree by batched products at the
mode.  Zero padding is exact: padded rows lie below every pivot, so they
never enter a reflector, and their Q rows come out exactly 0.

The leaf is the panel kernel (through ``ops.panel_kernel``:
``ops/csrc/panel_qr.cu`` for n <= 128, ``ops/csrc/panel_wide.cu`` up to
n = 512, the JAX package's panel kernel's edge) and the blocked
Householder of ``ops.householder`` past it (the JAX package's default
leaf at every n), unless the caller asks for one.  The kernel returns
Q^T (B, n, L); the tree keeps it as it is and reads it through a
transposed view in the backward product.  The inner nodes take the same
panel kernel up to n = 512, at the largest fan-in whose (f n, n) node it
holds (:func:`inner_route`: 2 at n = 128, 8 at n <= 64), and the blocked
Householder at ``fanin`` past it, or wherever the caller asks for
``tree_impl="jnp"`` (the reference's inner route).  The backward drops
each level's Q once its product has read it.  On the card each of its
products at a split mode (the policy's product one of the split modes'
own functions) is one launch of ``ops/csrc/split_mm.cu``
(:func:`_q_product`); every other product is ``policy.mm``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import diff
from tsqr_tpu_torch.ops import householder, panel_kernel, split_mm
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils import trace

Tensor = torch.Tensor

# the Householder leaf's height; the kernel leaf's is
# panel_kernel.leaf_rows(n): the largest tile panel_qr.cu's shared memory
# holds for n <= 128, panel_kernel.L_WIDE_MAX past it
DEFAULT_LEAF_ROWS = 2048
DEFAULT_FANIN = 8
DEFAULT_BLOCK = 24

# Above LEAF_SEQ_THRESHOLD leaf elements (m_pad n), the leaf QR and the
# layer-0 backward product run chunk by chunk over ~LEAF_CHUNK_ELEMS
# leaf elements instead of over the whole batch at once.  The peak of
# the tree is the layer-0 product: on the card at a split mode the
# kernel forms the parts on chip, so the padded A, the leaves' Q^T and Q,
# three panel-sized float32 tensors (beside c, n / L of one); through
# policy.mm (fp32, the emulation modes, a CPU tensor) the split parts and
# per-order products add up to about ten.  Ten of 2^30 elements are
# 40 GiB, half of the H100's 80 GB, which leaves the caller room for its
# own data; chunks of 2^28 elements keep the live temporaries near
# 10 GiB above that.
LEAF_SEQ_THRESHOLD = 1 << 30
LEAF_CHUNK_ELEMS = 1 << 28

_KERNEL_IMPLS = ("pallas", "pallas_sb")
_PLAIN_IMPLS = ("pallas_interpret", "pallas_sb_interpret")
# widest n of the JAX package's panel kernel (its tiles T L <= 8192 with
# T >= 8 and L >= 2 n, tsqr_tpu/core/tsqr.py::_pick_sb_tiles); past it
# its wrapper takes the blocked Householder
PANEL_SB_N_MAX = 512


def leaf_impl(impl: str | None, n: int) -> str:
    """The leaf's batched QR at width n: None is the panel kernel
    ("pallas_sb") for n <= ``PANEL_SB_N_MAX`` and the blocked
    Householder ("jnp") past it.  A panel impl asked for past
    ``PANEL_SB_N_MAX`` takes the blocked Householder, as the JAX
    package's wrapper does."""
    if impl is None:
        return "pallas_sb" if n <= PANEL_SB_N_MAX else "jnp"
    if impl in _KERNEL_IMPLS + _PLAIN_IMPLS and n > PANEL_SB_N_MAX:
        return "jnp"
    return impl


def inner_route(tree_impl: str | None, n: int, fanin: int) -> tuple[str, int]:
    """The inner nodes' batched QR and fan-in at width n: ``tree_impl``
    read as :func:`leaf_impl` reads ``impl`` (None is the panel kernel up
    to ``PANEL_SB_N_MAX``, the blocked Householder past it).  A panel
    route reduces at the largest power of two f <= ``fanin`` whose
    (f n, n) node the kernel holds, f n <= ``panel_kernel.leaf_rows(n)``
    (f = 2 at n = 128, 4 at n = 256, 2 at n = 512, 8 at n <= 64 with
    fan-in 8); the blocked Householder reduces at ``fanin``.  ``fanin``
    is a power of two, so f divides every level of a ``plan_tree``
    tree."""
    impl = leaf_impl(tree_impl, n)
    if impl not in _KERNEL_IMPLS + _PLAIN_IMPLS:
        return impl, fanin
    f, rows = fanin, panel_kernel.leaf_rows(n)
    while f > 2 and f * n > rows:
        f //= 2
    return impl, f


def default_leaf_rows(n: int, impl: str | None = None) -> int:
    """The leaf height ``tsqr`` takes with ``leaf_rows=None``: the panel
    kernel's leaf at n (``panel_kernel.leaf_rows``) for a panel leaf,
    else ``DEFAULT_LEAF_ROWS``."""
    if leaf_impl(impl, n) in _KERNEL_IMPLS + _PLAIN_IMPLS:
        return panel_kernel.leaf_rows(n)
    return DEFAULT_LEAF_ROWS


def _leaf_chunks(bs: int, elems_per_leaf: int) -> int:
    """Number of sequential leaf chunks (1 = the whole batch at once)."""
    if bs * elems_per_leaf <= LEAF_SEQ_THRESHOLD:
        return 1
    target = max(1, LEAF_CHUNK_ELEMS // elems_per_leaf)  # leaves per chunk
    s = 1
    while s < bs and bs // s > target:
        s *= 2
    return s


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_tree(m: int, n: int, leaf_rows: int = DEFAULT_LEAF_ROWS,
              fanin: int = DEFAULT_FANIN) -> tuple[int, int, int]:
    """Choose (batch_size, leaf_rows, m_padded) for an (m, n) panel:
    equal 8-row-aligned leaves of at least 2n rows, a leaf count that is
    a power of ``fanin`` (2, 4, 8, ...), zero padding below."""
    if fanin < 2 or fanin & (fanin - 1):
        raise ValueError(f"fanin must be a power of two >= 2, got {fanin}")
    leaf_rows = max(leaf_rows, _round_up(2 * n, 8))
    if m <= leaf_rows:
        mp = _round_up(m, 8)
        return 1, mp, mp
    n_leaves = -(-m // leaf_rows)
    bs = fanin
    while bs < n_leaves:
        bs *= fanin
    # equal leaves, 8-row aligned; padding overhead <= 8 bs rows
    L = max(_round_up(-(-m // bs), 8), _round_up(n, 8))
    return bs, L, bs * L


def _pad_rows(a: Tensor, m_pad: int) -> Tensor:
    m = a.shape[0]
    if m_pad == m:
        return a
    return torch.cat([a, a.new_zeros(m_pad - m, a.shape[1])])


def _q_product(mm: Callable, x: Tensor, c: Tensor) -> Tensor:
    """One product of the Q build, x (B, M, n) @ c (B, n, n), counted by
    route in ``tsqr.q_build.kernel`` or ``tsqr.q_build.mm``: the kernel on
    the card where ``mm`` is one of the split modes' own products
    (``split_mm.PARTS``), whatever the policy's mode is called."""
    parts = split_mm.PARTS.get(mm) if x.is_cuda else None
    if parts is None:
        trace.count("tsqr.q_build.mm")
        return mm(x, c)
    trace.count("tsqr.q_build.kernel")
    return split_mm.batched_split_mm(x, c, parts)


def _make_batched_qr(policy: modes.Policy, impl: str,
                     block: int) -> Callable[[Tensor], tuple[Tensor, Tensor]]:
    """Batched-QR factory: (B, rows, n) -> (Q (B, rows, n), R (B, n, n)).

    "jnp": the blocked Householder at ``block``.  "pallas", "pallas_sb"
    (the reference's names for its two panel kernels): the CUDA panel
    kernel on a CUDA tensor, its plain version on a CPU tensor; the
    kernel's W-Y block is its own 16 columns.  "pallas_interpret",
    "pallas_sb_interpret": the kernel's plain version on either device.
    The panel kernels' Q comes back as the transposed view of their
    Q^T."""
    if impl == "jnp":
        return lambda x: householder.blocked_householder_qr(x, policy.mm,
                                                            block)
    if impl in _KERNEL_IMPLS:
        fn = panel_kernel.panel_qr_batched
    elif impl in _PLAIN_IMPLS:
        fn = panel_kernel.panel_qr_reference
    else:
        raise ValueError(f"unknown impl {impl!r}")

    def call(x):
        qt, r = fn(x, policy.mode.value)
        return qt.transpose(-2, -1), r
    return call


@diff.differentiable(unless=lambda b: (not b["want_q"])
                     or b["collect_level_q"])
def tsqr(a: Tensor,
         mode: modes.ComputeMode | str | modes.Policy = "fp32",
         leaf_rows: int | None = None,
         fanin: int = DEFAULT_FANIN,
         leaf_qr: Callable | None = None,
         impl: str | None = None,
         block: int = DEFAULT_BLOCK,
         collect_level_q: bool = False,
         want_q: bool = True,
         tree_impl: str | None = None,
         seq_chunks: int | None = None,
         device=None):
    """Thin QR of a tall-skinny (m, n) matrix: returns (Q (m, n),
    R (n, n)).  Runs on the card unless ``device="cpu"``.  Differentiable
    in ``a`` (``core/diff.py``) unless ``want_q`` is False or
    ``collect_level_q`` is set.

    Args:
      a: (m, n) with m >= n.
      mode: precision policy (see :mod:`tsqr_tpu_torch.modes`).
      leaf_rows: target leaf height; None is the panel kernel's leaf at
        this n (``panel_kernel.leaf_rows``) for the kernel leaf, else
        ``DEFAULT_LEAF_ROWS`` (:func:`default_leaf_rows`).
      fanin: tree fan-in (a power of two): the leaf count is a power of
        it (:func:`plan_tree`), and the blocked Householder's inner nodes
        reduce at it; the panel kernel's reduce at the largest power of
        two up to it whose node the kernel holds (:func:`inner_route`).
      leaf_qr: optional override of the leaf's batched QR,
        (B, L, n) -> (Q, R).
      impl: the leaf's batched QR (see :func:`_make_batched_qr` and
        :func:`leaf_impl`); None is the panel kernel ("pallas_sb") for
        n <= 512, the blocked Householder ("jnp") past it.
      block: W-Y block width of the blocked Householder (a "jnp" leaf or
        inner node); the panel kernel's block is its own 16 columns.
      collect_level_q: also return the per-level Q batches:
        (q, r, [level Qs]).
      want_q: False skips the backward Q reconstruction: (None, R).
      tree_impl: batched QR of the inner nodes, read as ``impl``: None
        is the panel kernel for n <= 512 (its plain version on a CPU
        tensor) at :func:`inner_route`'s fan-in, the blocked Householder
        past it; "jnp" is the blocked Householder at ``fanin``, the
        reference's route.  Each level counts its route in
        ``tsqr.inner.kernel`` or ``tsqr.inner.householder``.
      seq_chunks: sequential leaf-chunk count for the leaf QR and the
        layer-0 backward product; None picks 1 below LEAF_SEQ_THRESHOLD
        leaf elements, else enough to keep each chunk near
        LEAF_CHUNK_ELEMS.
    """
    with trace.span("tsqr.tree"):
        policy = modes.resolve(mode)
        a = _device.place(a, device, "tsqr")
        m, n = a.shape
        if m < n:
            raise ValueError(f"tsqr requires m >= n, got {tuple(a.shape)}")
        a = a.to(torch.float32)
        mm = policy.mm
        impl = leaf_impl(impl, n)
        if leaf_rows is None:
            leaf_rows = (default_leaf_rows(n, impl) if leaf_qr is None
                         else DEFAULT_LEAF_ROWS)
        if leaf_qr is None:
            leaf_qr = _make_batched_qr(policy, impl, block)
        tree_impl, tree_fanin = inner_route(tree_impl, n, fanin)
        batched_qr = _make_batched_qr(policy, tree_impl, block)
        route = ("tsqr.inner.householder" if tree_impl == "jnp"
                 else "tsqr.inner.kernel")
        io, work = policy.io_dtype, policy.work_dtype

        bs, L, m_pad = plan_tree(m, n, leaf_rows, fanin)
        a = _pad_rows(a, m_pad)

        if bs == 1:
            with trace.span("tsqr.leaves"):
                q, r = leaf_qr(a[None])
            r_out = r[0].to(io)
            q_out = q[0, :m].to(io) if want_q else None
            return (q_out, r_out, [q]) if collect_level_q else (q_out, r_out)

        # ---- forward: leaf QR, then the R-reduction tree ----
        leaves = a.reshape(bs, L, n)
        seq = _leaf_chunks(bs, L * n) if seq_chunks is None else seq_chunks
        with trace.span("tsqr.leaves"):
            if seq > 1 and bs % seq == 0:
                outs = [leaf_qr(c)
                        for c in leaves.reshape(seq, bs // seq, L, n)]
                q0 = [qc.to(work) for qc, _ in outs]
                r = torch.cat([rc for _, rc in outs])
            else:
                seq = 1
                q0, r = leaf_qr(leaves)
                q0 = [q0.to(work)]

        qs: list[Tensor] = []
        widths: list[int] = []
        while r.shape[0] > 1:
            b = r.shape[0]
            f = min(tree_fanin, b)
            with trace.span("tsqr.level", batch=b // f, fanin=f,
                            impl=tree_impl):
                qk, r = batched_qr(r.reshape(b // f, f * n, n))
                qs.append(qk.to(work))
            trace.count(route)
            widths.append(f)
        r_out = torch.triu(r[0])

        if not want_q:
            r_only = r_out.to(io)
            return (None, r_only, [torch.cat(q0)] + qs) if collect_level_q \
                else (None, r_only)

        # ---- backward: Q reconstruction down the tree ----
        levels = [torch.cat(q0)] + qs if collect_level_q else None
        with trace.span("tsqr.q_build"):
            # c starts as the root Q cut into per-child (n, n) blocks; each
            # level's Q is dropped once its product has read it, so the
            # layer-0 product runs beside c and the leaves' Q alone; prod
            # is (bk, f n, n), the layer-0 parts (bs / seq, L, n)
            c = qs.pop().to(torch.float32).reshape(widths.pop(), n, n)
            while qs:
                prod = _q_product(mm, qs.pop().to(torch.float32), c)
                c = prod.reshape(prod.shape[0] * widths.pop(), n, n)
            parts = [_q_product(mm, qc.to(torch.float32), cc)
                     for qc, cc in zip(q0, c.reshape(seq, bs // seq, n, n))]
            q = parts[0] if seq == 1 else torch.cat(parts)
            q = q.reshape(m_pad, n)[:m]
        if collect_level_q:
            return q.to(io), r_out.to(io), levels
        return q.to(io), r_out.to(io)


def get_batch_size(m: int, leaf_rows: int = DEFAULT_LEAF_ROWS,
                   fanin: int = DEFAULT_FANIN) -> int:
    """Leaf count of the tree."""
    return plan_tree(m, 1, leaf_rows, fanin)[0]


def get_batch_size_log2(m: int, leaf_rows: int = DEFAULT_LEAF_ROWS) -> int:
    """Tree depth in binary-equivalent levels."""
    return int(math.log2(get_batch_size(m, leaf_rows, 2)))


def get_working_q_size(m: int, n: int, leaf_rows: int = DEFAULT_LEAF_ROWS,
                       fanin: int = DEFAULT_FANIN) -> int:
    """Elements of the tree's Q storage (leaves plus every level)."""
    bs, L, m_pad = plan_tree(m, n, leaf_rows, fanin)
    wq = m_pad * n
    b = bs
    while b > 1:
        f = min(fanin, b)
        wq += (b // f) * f * n * n
        b //= f
    return wq


def get_working_r_size(m: int, n: int, leaf_rows: int = DEFAULT_LEAF_ROWS,
                       fanin: int = DEFAULT_FANIN) -> int:
    """Elements of ping-pong R storage."""
    bs, _, _ = plan_tree(m, n, leaf_rows, fanin)
    return 2 * bs * n * n


def working_memory_elems(m: int, n: int, leaf_rows: int = DEFAULT_LEAF_ROWS,
                         fanin: int = DEFAULT_FANIN) -> int:
    """Peak intermediate elements of the tree."""
    return (get_working_q_size(m, n, leaf_rows, fanin)
            + get_working_r_size(m, n, leaf_rows, fanin))
