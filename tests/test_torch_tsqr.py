"""The port's TSQR tree and BlockQR against the JAX package's (its jnp
route), on the same numpy inputs, all on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsqr_tpu.core import blockqr as jblockqr
from tsqr_tpu.core import tsqr as jtsqr
from tsqr_tpu_torch.core import blockqr, tsqr
from tsqr_tpu_torch.utils import validation

torch.set_num_threads(2)


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
