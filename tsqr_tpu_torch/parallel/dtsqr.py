"""Distributed TSQR, BlockQR and CholeskyQR over a process mesh.

Counterpart of ``tsqr_tpu/parallel/dtsqr.py``, in SPMD form: every rank
of a ``torch.distributed`` group runs the driver on its own row shard
and gets back its rows of Q and the whole (n, n) R, the same bits on
every rank for the tree drivers.  Where the JAX package maps one
program over a global array (``shard_map``), the port's collectives are
explicit calls of ``parallel/comm.py``; the JAX package's behaviour is
the contract, shard for shard.

Design (communication-avoiding, latency-bound payloads):

  * each rank factors its (m/D, n) shard by the local TSQR tree
    (``core/tsqr.py``, whose leaves are the panel kernel on the card);
  * the R factors cross ranks: one all-gather of the D (n, n) factors
    and a redundant QR of the stacked (D n, n) on every rank ("allgather"),
    or log2(D) pairwise exchanges of one (n, n) factor ("butterfly"),
    or, on a 2-D mesh, a butterfly over the chip axis and one gather
    over the slice axis (:func:`dtsqr_hier`);
  * each rank multiplies its local Q by its own (n, n) block of the
    tree's Q: no further communication.

Bytes between ranks per factorization: D n^2 4 (one all-gather),
independent of m.  The Gram drivers (:func:`dcholqr`, :func:`dqr_auto`'s
tiers 0-3, :func:`dqr_regen`) sum (n, n) Grams of ``modes.gram`` over the
ranks, two or three a factorization, also independent of m.

Every host decision that precedes a collective is taken alike on every
rank through ``comm.agree``; the JAX package gets that by construction
from its replicated ``lax.cond`` predicates.  The drivers that return
(Q, R) carry the QR gradient rule of ``core/diff.py`` with its sums over
the ranks (``dqr_auto`` unless ``return_info``).  Each runs on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import auto, blockqr, cholqr, diff, ooc
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.ops import householder
from tsqr_tpu_torch.parallel import comm
from tsqr_tpu_torch.parallel.mesh import ROWS_AXIS, Mesh, row_axes
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor
F32 = torch.float32


def _local_policy(policy: modes.Policy) -> modes.Policy:
    """Keep float32 IO inside the distributed composition."""
    return modes.Policy(policy.mode, F32, policy.work_dtype, policy.mm,
                        policy.corrected)


def _rows_reduce(b: dict):
    """The gradient rule's sum over ranks of a driver's row axis."""
    return comm.reducer(b["mesh"], row_axes(b["mesh"], b["axis"]))


def _check_shards(what: str, mesh: Mesh, axis, m_loc: int,
                  min_rows: int) -> None:
    """Equal shards of at least ``min_rows`` rows on every rank (the JAX
    package's divisibility and tallness asserts): one small all-reduce,
    so that every rank raises alike."""
    lo, neg_hi = comm.all_min([m_loc, -m_loc], mesh, axis)
    if lo != -neg_hi:
        raise ValueError(f"{what}: the ranks' shards must be equal, got "
                         f"{lo} to {-neg_hi} rows")
    if m_loc < min_rows:
        raise ValueError(f"{what}: each shard must stay tall, got {m_loc} "
                         f"rows for {min_rows}")


def _check_butterfly(axis, n_dev: int) -> None:
    if isinstance(axis, tuple):
        raise ValueError("the butterfly rides one axis; use dtsqr_hier on "
                         "a 2-D mesh")
    # n_dev sets the round count: a wrong one would skip rounds
    if n_dev < 1 or n_dev & (n_dev - 1):
        raise ValueError(f"the butterfly tree needs a power-of-two rank "
                         f"count, got {n_dev}")


def _ici_rtree_butterfly(r_loc: Tensor, mesh: Mesh, axis, n_dev: int,
                         mm) -> tuple[Tensor, Tensor]:
    """Pairwise-exchange (butterfly) R-tree: log2(D) rounds of one (n, n)
    exchange each.  Both members of a pair factor the identical stacked
    (2n, n), so R is the same bits on every rank.  Returns (c, R): this
    rank's (n, n) backward transform, Q_shard = Q_local c, and the top
    R."""
    n = r_loc.shape[1]
    idx = comm.linear_index(mesh, axis)
    r = r_loc
    c = torch.eye(n, dtype=F32, device=r.device)
    k = 1
    while k < n_dev:
        r_partner = comm.exchange(r, idx ^ k, mesh, axis)
        bit = (idx // k) % 2          # top (0) or bottom (1) of the pair
        top, bot = (r, r_partner) if bit == 0 else (r_partner, r)
        q_k, r = householder.blocked_householder_qr(
            torch.cat([top, bot]), mm=mm)                # (2n, n) QR
        c = mm(c, q_k[bit * n:(bit + 1) * n])
        k *= 2
    return c, r


def _tsqr_shard(a: Tensor, policy: modes.Policy, mesh: Mesh, axis,
                n_dev: int, tree: str = "allgather",
                **tsqr_kw) -> tuple[Tensor, Tensor]:
    """Per-shard body: local tree, cross-rank R-reduction, local Q
    update."""
    n = a.shape[1]
    mm = policy.mm
    q_loc, r_loc = tsqr_mod.tsqr(a, _local_policy(policy), device=a.device,
                                 **tsqr_kw)
    if tree == "butterfly":
        c, r_top = _ici_rtree_butterfly(r_loc.to(F32), mesh, axis, n_dev, mm)
        return mm(q_loc.to(F32), c), r_top
    # one all-gather of the (n, n) factors, then the redundant root QR
    rs = comm.all_gather_rows(r_loc.to(F32), mesh, axis)     # (D n, n)
    q_tree, r_top = householder.blocked_householder_qr(rs, mm=mm)
    idx = comm.linear_index(mesh, axis)
    c = q_tree[idx * n:(idx + 1) * n]                        # my block
    return mm(q_loc.to(F32), c), r_top


@diff.differentiable(reduce=_rows_reduce)
def dtsqr(a: Tensor, mesh: Mesh, mode="fp32", axis=ROWS_AXIS,
          tree: str = "allgather", device=None,
          **tsqr_kw) -> tuple[Tensor, Tensor]:
    """Distributed thin QR of a row-sharded (m, n): ``a`` is this rank's
    (m/D, n) shard; returns (this rank's rows of Q, R (n, n)), R the same
    bits on every rank.

    tree: "allgather" (one all-gather and a redundant (D n, n) root QR)
    or "butterfly" (log2(D) pairwise exchanges, (2n, n) node QRs; a
    power-of-two D on one axis).  On a 2-D mesh the allgather tree
    gathers over both axes; :func:`dtsqr_hier` crosses the slow axis
    once.  ``tsqr_kw`` go to the local :func:`tsqr`."""
    if tree not in ("allgather", "butterfly"):
        raise ValueError(f"unknown tree {tree!r}")
    policy = modes.resolve(mode)
    a = _device.place(a, device, "dtsqr")
    axis = row_axes(mesh, axis)
    n_dev = comm.axes_size(mesh, axis)
    m_loc, n = a.shape
    if tree == "butterfly":
        _check_butterfly(axis, n_dev)
    _check_shards("dtsqr", mesh, axis, m_loc, n)
    q, r = _tsqr_shard(a.to(F32), policy, mesh, axis, n_dev, tree,
                       **tsqr_kw)
    return q.to(policy.io_dtype), torch.triu(r).to(policy.io_dtype)


def _tsqr_shard_hier(a: Tensor, policy: modes.Policy, mesh: Mesh,
                     slice_axis: str, chip_axis: str, n_chips: int,
                     **tsqr_kw) -> tuple[Tensor, Tensor]:
    """Per-shard body of the two-level tree: local TSQR, a butterfly over
    the chip axis (log2(chips) rounds of one (n, n) exchange), then one
    all-gather of the per-slice roots over the slice axis and a redundant
    (slices n, n) root QR; Q correction c_chip c_slice."""
    n = a.shape[1]
    mm = policy.mm
    q_loc, r_loc = tsqr_mod.tsqr(a, _local_policy(policy), device=a.device,
                                 **tsqr_kw)
    c1, r_slice = _ici_rtree_butterfly(r_loc.to(F32), mesh, chip_axis,
                                       n_chips, mm)
    rs = comm.all_gather_rows(r_slice, mesh, slice_axis)
    q_tree, r_top = householder.blocked_householder_qr(rs, mm=mm)
    sidx = comm.linear_index(mesh, slice_axis)
    c2 = q_tree[sidx * n:(sidx + 1) * n]
    return mm(q_loc.to(F32), mm(c1, c2)), r_top


@diff.differentiable(reduce=lambda b: comm.reducer(
    b["mesh"], (b["slice_axis"], b["chip_axis"])))
def dtsqr_hier(a: Tensor, mesh: Mesh, mode="fp32", slice_axis: str = "slices",
               chip_axis: str = "chips", device=None,
               **tsqr_kw) -> tuple[Tensor, Tensor]:
    """Multi-slice distributed thin QR over a 2-D (slices, chips) mesh
    (``mesh.make_mesh2d``): the chip-axis levels of the tree are a
    butterfly of (n, n) exchanges, and exactly one all-gather crosses the
    slice axis (slices n^2 4 bytes, independent of m).  ``a`` is this
    rank's shard of the slice-major row blocks; returns (this rank's rows
    of Q, R (n, n))."""
    policy = modes.resolve(mode)
    a = _device.place(a, device, "dtsqr_hier")
    n_chips = mesh.shape[chip_axis]
    m_loc, n = a.shape
    _check_butterfly(chip_axis, n_chips)
    _check_shards("dtsqr_hier", mesh, (slice_axis, chip_axis), m_loc, n)
    q, r = _tsqr_shard_hier(a.to(F32), policy, mesh, slice_axis, chip_axis,
                            n_chips, **tsqr_kw)
    return q.to(policy.io_dtype), torch.triu(r).to(policy.io_dtype)


def _dblockqr_shard(a: Tensor, policy: modes.Policy, mesh: Mesh, axis,
                    n_dev: int, panel_width: int, reorth: bool,
                    **tsqr_kw) -> tuple[Tensor, Tensor]:
    """Per-shard BlockQR: the projections Q^T A_b and Q^T Q_b contract
    over the sharded m axis, so ``_panel_step`` sums them over the ranks
    (its ``reduce`` hook); each panel is factored by the distributed
    tree.  Everything else is local."""
    mm = policy.trailing_mm
    m_loc, n = a.shape
    nb = min(panel_width, n)
    psum = comm.reducer(mesh, axis)

    def _tsqr_local(x):
        return _tsqr_shard(x, policy, mesh, axis, n_dev, **tsqr_kw)

    q = a.new_zeros(m_loc, n)
    r = a.new_zeros(n, n)
    for c0 in range(0, n, nb):
        blockqr._panel_step(q, r, a[:, c0:c0 + nb], c0, mm, _tsqr_local,
                            reorth, reduce=psum)
    return q, torch.triu(r)


@diff.differentiable(reduce=_rows_reduce)
def dqr(a: Tensor, mesh: Mesh, mode="fp32", reorth: bool = False,
        panel_width: int = 128, axis=ROWS_AXIS, device=None,
        **tsqr_kw) -> tuple[Tensor, Tensor]:
    """Distributed BlockQR of a row-sharded (m, n), n past the panel width
    too: returns (this rank's rows of Q, R (n, n)).  2-D meshes sum over
    both axes.  ``tsqr_kw`` (``tree=`` among them) go to the
    distributed tree of each panel."""
    policy = modes.resolve(mode)
    a = _device.place(a, device, "dqr")
    axis = row_axes(mesh, axis)
    n_dev = comm.axes_size(mesh, axis)
    m_loc, n = a.shape
    if n > m_loc * n_dev:
        raise ValueError(f"BlockQR requires m >= n, got m={m_loc * n_dev}, "
                         f"n={n}")
    if tsqr_kw.get("tree") == "butterfly":
        _check_butterfly(axis, n_dev)
    _check_shards("dqr", mesh, axis, m_loc, min(panel_width, n))
    q, r = _dblockqr_shard(a.to(F32), policy, mesh, axis, n_dev,
                           panel_width, reorth, **tsqr_kw)
    return q.to(policy.io_dtype), r.to(policy.io_dtype)


def _gram_psum(x: Tensor, policy: modes.Policy, mesh: Mesh, axis) -> Tensor:
    return comm.psum(modes.gram(x, policy), mesh, axis)


def _dcholqr_shard(a: Tensor, policy: modes.Policy, mesh: Mesh, axis,
                   method: str) -> tuple[Tensor, Tensor]:
    """Per-shard CholeskyQR: G = sum over ranks of A_loc^T A_loc, one
    (n, n) all-reduce a pass in place of the whole R-tree; everything
    else is local products."""
    mm = policy.mm
    m_loc, n = a.shape
    g = _gram_psum(a, policy, mesh, axis)
    if method == "cholqr3":
        m_glob = m_loc * comm.axes_size(mesh, axis)
        r1 = cholqr._chol_r(g, shift=cholqr._shift_value(g, m_glob, n))
    else:
        r1 = cholqr._chol_r(g)
    q1 = cholqr._q_pass(a, r1, mm)
    r2 = cholqr._chol_r(_gram_psum(q1, policy, mesh, axis))
    q2 = cholqr._q_pass(q1, r2, mm)
    r = modes.mm_fp32(r2, r1)
    if method == "cholqr3":
        r3 = cholqr._chol_r(_gram_psum(q2, policy, mesh, axis))
        q2 = cholqr._q_pass(q2, r3, mm)
        r = modes.mm_fp32(r3, r)
    return q2, torch.triu(r)


@diff.differentiable(reduce=_rows_reduce)
def dcholqr(a: Tensor, mesh: Mesh, mode="fp32", method: str = "cholqr3",
            axis=ROWS_AXIS, device=None) -> tuple[Tensor, Tensor]:
    """Distributed CholeskyQR2 ("cholqr2") or shifted CholeskyQR3
    ("cholqr3") of a row-sharded (m, n): returns (this rank's rows of Q,
    R (n, n)).  Two or three (n, n) all-reduces, independent of m; on a
    2-D mesh they sum over both axes."""
    if method not in ("cholqr2", "cholqr3"):
        raise ValueError(f"dcholqr: unknown method {method!r}")
    policy = modes.resolve(mode)
    a = _device.place(a, device, "dcholqr")
    axis = row_axes(mesh, axis)
    m_loc, n = a.shape
    _check_shards("dcholqr", mesh, axis, m_loc, n)
    q, r = _dcholqr_shard(a.to(F32), policy, mesh, axis, method)
    return q.to(policy.io_dtype), r.to(policy.io_dtype)


def _orth_of(gq: Tensor) -> Tensor:
    n = gq.shape[-1]
    eye = torch.eye(n, dtype=gq.dtype, device=gq.device)
    return torch.linalg.norm(gq - eye) / math.sqrt(n)


def _dqr_auto_shard(a: Tensor, policy: modes.Policy, mesh: Mesh, axis,
                    n_dev: int, tol: float, eps: float,
                    **tsqr_kw) -> tuple[Tensor, Tensor, int, Tensor]:
    """Per-shard predictive ladder: (q, r, tier, kappa2_est).

    The tier-0 Gram sum is also the kappa estimator's input: it is the
    same on every rank, so every rank computes the same kappa^2 bound,
    and ``comm.agree`` makes each tier's gate one decision of all ranks
    before the next collective."""
    mm = policy.mm
    m_loc, n = a.shape
    k2max = auto._kappa2_max("cholqr1", eps, tol)

    def gram_psum(x):
        return _gram_psum(x, policy, mesh, axis)

    def agree(flag) -> bool:
        return comm.agree(bool(flag), mesh, axis)   # False for NaN

    # ---- tier 0: the summed Gram and the predictive kappa^2 bound ----
    g = gram_psum(a)
    g = (g + g.T) * 0.5
    r1 = cholqr._chol_r(g, shift=None)
    rinv1 = cholqr._rinv(r1)
    minv = modes.mm_fp32(rinv1, rinv1.T)
    kappa2_est = (cholqr._psd_norm2_bound(g)
                  * cholqr._psd_norm2_bound(minv)).reshape(1, 1)

    def tier4():
        q, r = _dblockqr_shard(a, policy, mesh, axis, n_dev, panel_width=n,
                               reorth=True, **tsqr_kw)
        return q, r, 4, kappa2_est

    if agree(kappa2_est < k2max):
        # tier 1: cholqr1 from the shared factor, one local pass and no
        # further communication
        return mm(a, rinv1), torch.triu(r1), 1, kappa2_est

    # ---- tier 2: shifted CholeskyQR3 reusing the summed Gram ----
    m_glob = m_loc * n_dev
    r1s = cholqr._chol_r(g, shift=cholqr._shift_value(g, m_glob, n))
    q1 = cholqr._q_pass(a, r1s, mm)
    r2 = cholqr._chol_r(gram_psum(q1))
    q2 = cholqr._q_pass(q1, r2, mm)
    r3 = cholqr._chol_r(gram_psum(q2))
    q3 = cholqr._q_pass(q2, r3, mm)
    r_m = modes.mm_fp32(r3, modes.mm_fp32(r2, r1s))
    # the measured gate: one more (n, n) sum
    if agree(_orth_of(gram_psum(q3)) < tol):
        return q3, torch.triu(r_m), 2, kappa2_est
    if policy.mode in cholqr._CHEAP_DOT:
        return tier4()

    # ---- tier 3: the iterated shifted CholeskyQR, one (n, n) sum a pass
    def gram_of_f(f):
        gg = gram_psum(mm(a, f))
        return (gg + gg.T) * 0.5

    f, rt, gexit, _, _ = cholqr._iter_shifted_loop(
        g, gram_of_f, lambda gg: cholqr._shift_value(gg, m_glob, n), n,
        cholqr._iter_polish_k2(policy), 16, agree)
    # the tail factor applied to the recomputed shard panel x = A F
    r2i = cholqr._chol_r(gexit)
    q_i = cholqr._q_pass(mm(a, f), r2i, mm)
    r_i = torch.triu(modes.mm_fp32(r2i, rt))
    if agree(_orth_of(gram_psum(q_i)) < tol):
        return q_i, r_i, 3, kappa2_est
    return tier4()


@diff.differentiable(unless=lambda b: b["return_info"], reduce=_rows_reduce)
def dqr_auto(a: Tensor, mesh: Mesh, mode="fp32", axis=ROWS_AXIS,
             return_info: bool = False, device=None, **tsqr_kw):
    """Distributed self-validating QR: the predictive ladder of
    ``core/auto.qr_auto_fused`` over a row-sharded (m, n), its tiers 0-3
    on the Gram sums of ``modes.gram`` and tier 4 the distributed
    BlockQR with CGS2 over the panel kernel's trees.  The fast tier costs
    one (n, n) all-reduce, the robust tier a few, independent of m.

    Returns (this rank's rows of Q, R (n, n)), or with ``return_info``
    also ``{"tier": int, "kappa2_est": (1, 1)}``, both the same on every
    rank.  2-D meshes sum over both axes."""
    policy = modes.resolve(mode)
    a = _device.place(a, device, "dqr_auto")
    axis = row_axes(mesh, axis)
    n_dev = comm.axes_size(mesh, axis)
    m_loc, n = a.shape
    _check_shards("dqr_auto", mesh, axis, m_loc, n)
    tol = auto._TOL.get(policy.mode, 1e-4)
    eps = auto._EPS_GATE.get(policy.mode, 1e-6)
    q, r, tier, k2 = _dqr_auto_shard(a.to(F32), policy, mesh, axis, n_dev,
                                     tol, eps, **tsqr_kw)
    q, r = q.to(policy.io_dtype), r.to(policy.io_dtype)
    if return_info:
        return q, r, {"tier": tier, "kappa2_est": k2}
    return q, r


def dqr_regen(gen_chunk: Callable[[int], Tensor], m: int, n: int, mesh: Mesh,
              mode="bf16", method: str = "cholqr2",
              chunk_rows: int = 1 << 21, axis=ROWS_AXIS,
              device=None) -> tuple[Tensor, dict]:
    """Matrix-free distributed streamed QR: ``core.ooc.qr_regen`` over a
    mesh.  A is ``gen_chunk(i)`` over global chunk indices; rank d makes
    chunks [d c, (d + 1) c) itself, so each rank's device holds one
    (chunk_rows, n) tile whatever m.  One (n, n) all-reduce a Gram pass,
    and one (n, n) and two scalar all-reduces for the streamed metrics.
    Returns (R, {orthogonality, residual, rinv}), the same on every
    rank; Q is never formed."""
    policy = modes.resolve(mode)
    dev = _device.resolve(device, "dqr_regen")
    axis = row_axes(mesh, axis)
    n_dev = comm.axes_size(mesh, axis)
    if m % (chunk_rows * n_dev):
        raise ValueError(f"m={m} must divide into chunks of {chunk_rows} "
                         f"rows over {n_dev} ranks")
    per_dev = m // chunk_rows // n_dev
    d = comm.linear_index(mesh, axis)

    def local_gen(i):
        return gen_chunk(d * per_dev + i)

    r, orth, resid, rinv = ooc._regen_body(
        local_gen, per_dev, n, chunk_rows, policy, method,
        reduce=comm.reducer(mesh, axis), device=dev,
        agree=lambda flag: comm.agree(flag, mesh, axis))
    return r, {"orthogonality": orth, "residual": resid, "rinv": rinv}


def _sketch_local(a: Tensor, seed: int, index: int, l: int,
                  chunk_rows: int) -> Tensor:
    """Rank ``index``'s partial Omega_d A_d: Omega_d drawn chunk by chunk
    from a generator seeded from (seed, index) and never held whole."""
    gen = torch.Generator(device=a.device).manual_seed(
        ooc._chunk_seed(seed, index))
    return cholqr.sketch_gaussian(a, gen, l, chunk_rows=chunk_rows)


def dsketch(a: Tensor, seed: int, l: int, mesh: Mesh, axis=ROWS_AXIS,
            chunk_rows: int = 1 << 16, device=None) -> Tensor:
    """Distributed Gaussian sketch B = Omega A of a row-sharded (m, n):
    each rank draws its own columns of Omega (from (seed, rank index),
    never materialized) against its rows, and the (l, n) partials sum in
    one all-reduce, l n 4 bytes independent of m.  B comes back on every
    rank.  The draw is not the single-process ``sketch_gaussian``'s: the
    embedding's statistics are the contract, not its values."""
    a = _device.place(a, device, "dsketch")
    axis = row_axes(mesh, axis)
    _check_shards("dsketch", mesh, axis, a.shape[0], 1)
    b = _sketch_local(a.to(F32), seed, comm.linear_index(mesh, axis), l,
                      chunk_rows)
    return comm.psum(b, mesh, axis)
