"""The port's TSQR tree and BlockQR against the JAX package's (its jnp
route), on the same numpy inputs, all on the CPU."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu.core import blockqr as jblockqr
from tsqr_tpu.core import tsqr as jtsqr
from tsqr_tpu.ops import householder as jhouseholder
from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr, tsqr
from tsqr_tpu_torch.ops import householder, split_mm
from tsqr_tpu_torch.utils import trace, validation


def _matrix(m, n, seed=0):
    return np.random.default_rng(seed + m + n).uniform(
        -1, 1, (m, n)).astype(np.float32)


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


# m = 2000 in 256-row leaves at fan-in 4: 16 leaves of 128 rows (48 rows
# of zero padding), two inner levels
M, N, LEAF, FANIN = 2000, 16, 256, 4


@pytest.mark.parametrize("impl", [None, "jnp"])
@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
def test_tsqr_matches_jax(mode, impl):
    a = _matrix(M, N)
    q, r = tsqr.tsqr(torch.from_numpy(a), mode, leaf_rows=LEAF, fanin=FANIN,
                     impl=impl, device="cpu")
    qj, rj = jtsqr.tsqr(jnp.asarray(a), mode, leaf_rows=LEAF, fanin=FANIN,
                        impl="jnp")
    # the same tree and sign convention; the leaf's reflector sums run in
    # other orders (the kernel's plain version, or the blocked
    # Householder at block 24): float32 grade
    assert _rel(r, rj) <= 1e-5 and _rel(q, qj) <= 1e-5
    assert validation.orthogonality(q) < 1e-6
    assert validation.residual(a, q, r) < 1e-6
    rn = r.numpy()
    assert np.array_equal(np.triu(rn), rn)


def test_tsqr_r_only_and_level_qs_match_jax():
    a = _matrix(M, N, 1)
    at = torch.from_numpy(a)
    _, r_full = tsqr.tsqr(at, "fp32", leaf_rows=LEAF, fanin=FANIN,
                          device="cpu")
    q_none, r_only = tsqr.tsqr(at, "fp32", leaf_rows=LEAF, fanin=FANIN,
                               want_q=False, device="cpu")
    assert q_none is None and torch.equal(r_only, r_full)
    q, r, levels = tsqr.tsqr(at, "fp32", leaf_rows=LEAF, fanin=FANIN,
                             collect_level_q=True, device="cpu")
    _, _, levels_j = jtsqr.tsqr(jnp.asarray(a), "fp32", leaf_rows=LEAF,
                                fanin=FANIN, impl="jnp",
                                collect_level_q=True)
    assert [tuple(x.shape) for x in levels] == [tuple(x.shape)
                                                 for x in levels_j]
    for lv in levels:  # every level's Q tiles are orthonormal
        lv64 = lv.double()
        g = lv64.transpose(1, 2) @ lv64
        assert float((g - torch.eye(N, dtype=torch.float64)).abs().max()) \
            < 1e-5


@pytest.mark.parametrize("tree_impl,n,fanin,want", [
    (None, 16, 4, ("pallas_sb", 4)),     # (64, 16) nodes fit: fan-in kept
    (None, 64, 8, ("pallas_sb", 8)),
    (None, 128, 8, ("pallas_sb", 2)),    # 2 n <= 288 < 4 n
    (None, 256, 8, ("pallas_sb", 4)),    # 4 n <= 1024 rows
    (None, 512, 8, ("pallas_sb", 2)),
    (None, 513, 8, ("jnp", 8)),          # past the kernels: Householder
    (None, 1024, 4, ("jnp", 4)),
    ("jnp", 128, 8, ("jnp", 8)),         # asked for: the reference's route
    ("pallas", 128, 8, ("pallas", 2)),
    ("pallas_sb_interpret", 256, 8, ("pallas_sb_interpret", 4))])
def test_inner_route_fits_the_node_to_the_panel_kernel(tree_impl, n, fanin,
                                                       want):
    assert tsqr.inner_route(tree_impl, n, fanin) == want


# (2048, 128) at fan-in 8: 8 leaves of 256 rows; the kernel's inner nodes
# reduce at fan-in 2 (three levels of (256, 128) nodes), the blocked
# Householder's at 8 (one (1024, 128) node)
M128, LEAF128 = 2048, 288
INNER_ROUTES = {None: ("kernel", [(4, 256, 128), (2, 256, 128),
                                  (1, 256, 128)]),
                "jnp": ("householder", [(1, 1024, 128)])}


@functools.lru_cache(maxsize=None)
def _jax_tree_128():
    """JAX's jnp tree at fp32, the reference of both modes' trees (both
    float32 grade): one compile (~5 s) for the four cases."""
    a = _matrix(M128, 128, 7)
    return jtsqr.tsqr(jnp.asarray(a), "fp32", leaf_rows=LEAF128, fanin=8,
                      impl="jnp", collect_level_q=True)


@pytest.mark.parametrize("tree_impl", [None, "jnp"])
@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
def test_tsqr_inner_routes_at_n128_match_jax(mode, tree_impl):
    """The inner nodes on the panel kernel's route (its plain version on
    the CPU) and on the blocked Householder, against the JAX package's
    jnp tree at fp32: level Qs on each route, one count a level, and R
    in canonical signs at float32 grade (the kernel's tree reduces at
    another fan-in than JAX's, so Q and R differ in their roundings)."""
    a = _matrix(M128, 128, 7)
    route, shapes = INNER_ROUTES[tree_impl]
    before = trace.counts("tsqr.inner.")
    with trace.collect() as col:
        q, r, levels = tsqr.tsqr(torch.from_numpy(a), mode,
                                 leaf_rows=LEAF128, fanin=8,
                                 tree_impl=tree_impl, collect_level_q=True,
                                 device="cpu")
    assert trace.counts("tsqr.inner.") - before == {route: len(shapes)}
    impl = "jnp" if tree_impl == "jnp" else "pallas_sb"
    assert [s.attrs for s in col.spans if s.name == "tsqr.level"] == [
        {"batch": b, "fanin": L // 128, "impl": impl} for b, L, _ in shapes]
    assert [tuple(x.shape) for x in levels] == [(8, 256, 128)] + shapes
    for lv in levels:  # every level's Q tiles are orthonormal
        lv64 = lv.double()
        g = lv64.transpose(1, 2) @ lv64
        assert float((g - torch.eye(128, dtype=torch.float64)).abs().max()) \
            < 1e-5
    qj, rj, levels_j = _jax_tree_128()
    if tree_impl == "jnp":  # the reference's tree, level for level
        assert [tuple(x.shape) for x in levels_j] == [(8, 256, 128)] + shapes
        assert _rel(r, rj) <= 1e-5 and _rel(q, qj) <= 1e-5
    _, rs = householder.qr_sign_normalize(q, r)
    _, rjs = jhouseholder.qr_sign_normalize(qj, rj)
    assert _rel(rs, rjs) <= 1e-5
    assert validation.orthogonality(q) < 1e-6
    assert validation.residual(a, q, r) < 1e-6


def test_tsqr_sequential_chunks_give_the_same_factors():
    a = torch.from_numpy(_matrix(M, N, 2))
    q1, r1 = tsqr.tsqr(a, "bf16x6_cor", leaf_rows=LEAF, fanin=FANIN,
                       device="cpu")
    q4, r4 = tsqr.tsqr(a, "bf16x6_cor", leaf_rows=LEAF, fanin=FANIN,
                       seq_chunks=4, device="cpu")
    assert _rel(r4, r1) <= 1e-6 and _rel(q4, q1) <= 1e-6
    assert tsqr._leaf_chunks(4096, 256 * 128) == 1  # (2^20, 128): one launch
    assert tsqr._leaf_chunks(1 << 16, 256 * 128) == 8  # 2^31 elements


@pytest.mark.parametrize("m,n,leaf,fanin", [
    (2000, 16, 256, 4), (1 << 20, 128, 328, 8), (1 << 20, 128, 328, 4),
    (1 << 18, 128, 328, 8), (1000, 50, 2048, 8), (9211, 51, 512, 2)])
def test_plan_and_sizes_match_jax(m, n, leaf, fanin):
    assert tsqr.plan_tree(m, n, leaf, fanin) == jtsqr.plan_tree(m, n, leaf,
                                                                fanin)
    assert tsqr.get_batch_size(m, leaf, fanin) == jtsqr.get_batch_size(
        m, leaf, fanin)
    assert tsqr.get_batch_size_log2(m, leaf) == jtsqr.get_batch_size_log2(
        m, leaf)
    for f in ("get_working_q_size", "get_working_r_size",
              "working_memory_elems"):
        assert getattr(tsqr, f)(m, n, leaf, fanin) == getattr(jtsqr, f)(
            m, n, leaf, fanin)
    if (m, n, leaf) == (1 << 20, 128, 328):  # the tier-4 leaf launch
        assert tsqr.plan_tree(m, n, leaf, fanin) == (4096, 256, 1 << 20)


@pytest.mark.parametrize("m,n,plan", [
    # the cells' trees, whose leaves hold n rows: plan_tree's own
    (1 << 20, 128, (4096, 256, 1 << 20)), (1 << 20, 256, (4096, 256, 1 << 20)),
    (1 << 19, 512, (512, 1024, 1 << 19)),
    # plan_tree's power of 8 pads every leaf to n rows: the power of two
    (1 << 15, 128, (128, 256, 1 << 15)), (1 << 18, 128, (1024, 256, 1 << 18)),
    (4096, 128, (16, 256, 4096)), (2048, 512, (2, 1024, 2048))])
def test_tree_plan_pads_no_leaf_to_n_rows(m, n, plan):
    leaf = tsqr.default_leaf_rows(n)
    got = tsqr.tree_plan(m, n, leaf)
    assert got == plan
    bs, L, m_pad = got
    assert bs & (bs - 1) == 0 and bs * L == m_pad and m_pad - m < 8 * bs


def test_tsqr_builds_the_tree_plan():
    """At (4096, 128) ``tsqr``'s leaves are ``tree_plan``'s 16 of 256 rows
    (``plan_tree``'s 64 of 64 rows padded to 128, a tree of 8192 rows,
    before), then four levels at fan-in 2."""
    a = torch.from_numpy(_matrix(4096, 128))
    with trace.collect() as col:
        tsqr.tsqr(a, "bf16x6_cor", device="cpu")
    panels = [(s.attrs["batch"], s.attrs["L"]) for s in col.spans
              if s.name == "panel"]
    assert panels == [(16, 256), (8, 256), (4, 256), (2, 256), (1, 256)]


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("loop", ["unroll", "fori"])
def test_blockqr_matches_jax(loop, reorth):
    a = _matrix(512, 96)
    q, r = blockqr.qr(torch.from_numpy(a), "fp32", reorth=reorth,
                      panel_width=32, loop=loop, device="cpu")
    qj, rj = jblockqr.qr(jnp.asarray(a), "fp32", reorth=reorth,
                         panel_width=32, loop=loop)
    # three panels, each a single-leaf tree; the leaf is the kernel's
    # plain version here and JAX's blocked Householder there
    assert _rel(r, rj) <= 1e-5 and _rel(q, qj) <= 1e-5
    assert validation.orthogonality(q) < 1e-6
    assert validation.residual(a, q, r) < 1e-6


def test_blockqr_auto_loop_unrolls():
    # ten panels, the last one ragged: "auto" is the growing-slice loop
    # bit for bit, and the full-width loop agrees with it to rounding
    a = torch.from_numpy(_matrix(256, 76, 5))
    qa, ra = blockqr.qr(a, "fp32", reorth=True, panel_width=8, device="cpu")
    qu, ru = blockqr.qr(a, "fp32", reorth=True, panel_width=8,
                        loop="unroll", device="cpu")
    qf, rf = blockqr.qr(a, "fp32", reorth=True, panel_width=8, loop="fori",
                        device="cpu")
    assert torch.equal(qa, qu) and torch.equal(ra, ru)
    assert _rel(rf, ru) <= 1e-5 and _rel(qf, qu) <= 1e-5
    assert validation.orthogonality(qa) < 1e-6
    assert validation.residual(a, qa, ra) < 1e-6
    with pytest.raises(ValueError, match="loop"):
        blockqr.qr(a, "fp32", panel_width=8, loop="bogus", device="cpu")


def test_blockqr_panel_methods():
    a = torch.from_numpy(_matrix(512, 96, 3))
    q, r = blockqr.qr(a, "bf16x6_cor", panel_width=32,
                      panel_method="cholqr3_fused", device="cpu")
    assert validation.orthogonality(q) < 1e-5
    assert validation.residual(a, q, r) < 1e-5
    q, r = blockqr.qr(a, "fp32", panel_width=32, panel_method="cholqr2",
                      device="cpu")
    assert validation.orthogonality(q) < 1e-5
    assert validation.residual(a, q, r) < 1e-5
    with pytest.raises(ValueError, match="panel_method"):
        blockqr.qr(a, "fp32", panel_method="bogus", device="cpu")
    with pytest.raises(ValueError, match="m >= n"):
        blockqr.qr(a.T, "fp32", device="cpu")


# ---- the Q build's products: split_mm's limit and the route --------------

def _operands(transposed: bool, b=3, m=40, n=16, seed=4):
    """x (b, m, n) contiguous or the transposed view of a (b, n, m) tensor,
    as the panel kernels' Q^T reaches the Q build; c (b, n, n)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, n, m) if transposed
                                     else (b, m, n)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(-1, 1, (b, n, n)).astype(np.float32))
    return (x.transpose(1, 2) if transposed else x), c


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("parts", [1, 2, 3])
def test_split_mm_error_limit_passes_the_plain_version_and_refuses_a_part_short(
        parts, transposed):
    """The card tests' limit at each part count on the plain version (the
    kernel's products summed in another order), which stays under it, and
    on the control a part short, which goes over it."""
    x, c = _operands(transposed, b=4, m=128, n=64)
    limit = split_mm.ERROR_LIMIT[parts]
    plain = split_mm.split_mm_error(
        split_mm.split_mm_reference(x, c, parts), x, c)
    short = split_mm.split_mm_error(
        split_mm.split_mm_control(x, c, parts), x, c)
    assert plain <= limit < short, (plain, limit, short)


@pytest.mark.parametrize("mode", [md.value for md in modes.ALL_MODES])
def test_q_product_on_cpu_keeps_the_policy_product(mode):
    """On a CPU tensor every mode's product goes to ``policy.mm``, bit for
    bit, counted in ``tsqr.q_build.mm``."""
    policy = modes.resolve(mode)
    x, c = _operands(True)
    before = trace.counts("tsqr.q_build.")
    assert torch.equal(tsqr._q_product(policy.mm, x, c), policy.mm(x, c))
    assert trace.counts("tsqr.q_build.") - before == {"mm": 1}


def _custom_mm(a, b):
    return modes.mm_bf16x6_cor(a, b)


@pytest.mark.parametrize("policy,parts", [
    *[(modes.resolve(md), split_mm.PARTS.get(modes.resolve(md).mm))
      for md in modes.ALL_MODES],
    # the route follows the product, not the mode's name
    (modes.Policy(modes.ComputeMode.FP32, torch.float32, torch.float32,
                  modes.mm_bf16x6_cor), 3),
    (modes.Policy(modes.ComputeMode.BF16X6_COR, torch.float32,
                  torch.float32, _custom_mm), None),
    (modes.Policy(modes.ComputeMode.BF16, torch.bfloat16, torch.bfloat16,
                  modes.mm_bf16x3_cor_3term), None)])
def test_q_build_route_follows_the_policy_product(policy, parts):
    """On the card a split mode's own product takes the kernel at its part
    count; fp32, the emulation modes and any other product keep
    ``policy.mm``; off the card every product keeps it."""
    expected = {"fp32": None, "bf16": 1, "bf16_nocor": 1, "bf16x3_nocor": 2,
                "bf16x3_cor": 2, "bf16x6_cor": 3}
    if policy is modes.resolve(policy.mode):
        assert parts == expected.get(policy.name)
    assert split_mm.PARTS.get(policy.mm) == parts
    x, c = _operands(True)
    before = trace.counts("tsqr.q_build.")
    assert torch.equal(tsqr._q_product(policy.mm, x, c), policy.mm(x, c))
    assert trace.counts("tsqr.q_build.") - before == {"mm": 1}


@pytest.mark.parametrize("seq_chunks", [None, 2])
@pytest.mark.parametrize("mode,impl", [
    ("fp32", None), ("bf16x6_cor", None), ("bf16x3_cor_emu", "jnp")])
def test_cpu_tsqr_counts_each_q_build_product_on_the_policy_route(
        mode, impl, seq_chunks):
    """(2000, 16) in 16 leaves at fan-in 4: one product for the level
    below the root, then one a leaf chunk; none on the kernel, nothing
    launched, and none without Q.  (The panel kernel's modes leave out
    the emulation modes; the blocked Householder takes them.)"""
    a = torch.from_numpy(_matrix(M, N, 5))
    before = trace.counts("tsqr.q_build.")
    launches = trace.counts("launches.")
    q, r = tsqr.tsqr(a, mode, leaf_rows=LEAF, fanin=FANIN, impl=impl,
                     tree_impl=impl, seq_chunks=seq_chunks, device="cpu")
    assert trace.counts("tsqr.q_build.") - before == {
        "mm": 1 + (seq_chunks or 1)}
    assert trace.counts("launches.") == launches
    assert q.shape == (M, N) and r.shape == (N, N)
    before = trace.counts("tsqr.q_build.")
    tsqr.tsqr(a, mode, leaf_rows=LEAF, fanin=FANIN, impl=impl,
              tree_impl=impl, want_q=False, device="cpu")
    assert trace.counts("tsqr.q_build.") == before


@pytest.mark.parametrize("shapes,parts,match", [
    (((2, 8, 4), (2, 4, 5)), 4, "parts"),
    (((2, 8, 4), (2, 4, 5)), 0, "parts"),
    (((8, 4), (4, 5)), 3, "B, M, K"),
    (((2, 8, 4), (3, 4, 5)), 3, "do not match"),
    (((2, 8, 4), (2, 5, 5)), 3, "do not match"),
    (((2, 8, 4), (2, 4, 5)), 3, "cuda device")])
def test_split_mm_rejects_what_it_does_not_take(shapes, parts, match):
    x, c = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        split_mm.batched_split_mm(x, c, parts)


def test_split_mm_reads_either_layout_and_raises_on_other_strides():
    """The wrapper's layout of each operand, on meta tensors (no card,
    nothing launched): rows contiguous, columns contiguous (the tree's
    transposed Q^T), a unit extent either way; other strides and a
    device other than cuda raise."""
    x = torch.empty(4, 96, 32, device="meta")
    assert split_mm._layout(x) == (0, 32)
    assert split_mm._layout(x.transpose(1, 2).contiguous()
                            .transpose(1, 2)) == (1, 96)
    assert split_mm._layout(torch.empty(4, 1, 32, device="meta")) == (0, 32)
    assert split_mm._layout(torch.empty(4, 96, 1, device="meta")) == (0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        split_mm._layout(torch.empty(4, 96, 64, device="meta")[:, :, ::2])
    launches = trace.counts("launches.")
    with pytest.raises(ValueError, match="cuda device"):
        split_mm.batched_split_mm(x, torch.empty(4, 32, 32, device="meta"),
                                  3)
    assert trace.counts("launches.") == launches
