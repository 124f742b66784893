"""The panel kernel's plain version against the JAX package's Pallas panel
kernels (interpret mode), the wrapper's CPU dispatch, and the panel_qr
façade against the JAX package's, on the same numpy tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu.ops import pallas_panel, pallas_panel_sb
from tsqr_tpu.ops import panel_qr as jpanel_qr
from tsqr_tpu_torch.ops import panel_kernel, panel_qr
from tsqr_tpu_torch.utils import trace, validation


B, L, N = 8, 64, 16


def _tiles(seed=0):
    a = np.random.default_rng(seed).uniform(-1, 1, (B, L, N)).astype(
        np.float32)
    a[:, :, 5] = 0.0       # a zero column: H = I
    a[:, L - 8:, :] = 0.0  # zero rows below every pivot
    return a


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
def test_plain_version_matches_both_pallas_kernels(mode):
    a = _tiles()
    qt, r = panel_kernel.panel_qr_reference(torch.from_numpy(a), mode,
                                            block=8)
    qt_b3, r_b3 = pallas_panel.panel_qr_pallas(jnp.asarray(a), mode=mode,
                                               block=8, interpret=True)
    qt_b2, r_b2 = pallas_panel_sb.panel_qr_pallas_sb(
        jnp.asarray(a), mode=mode, block=8, tiles=8, interpret=True)
    assert qt.shape == (B, N, L) and r.shape == (B, N, N)
    # three orders of the same reflector sums (the two JAX kernels agree
    # with each other to 1.4e-7 in R here): float32 grade
    for qt_j, r_j in ((qt_b3, r_b3), (qt_b2, r_b2)):
        assert _rel(r, r_j) <= 1e-5
        assert _rel(qt, qt_j) <= 1e-5
    assert torch.equal(torch.tril(r, -1), torch.zeros_like(r))
    assert bool((qt[:, :, L - 8:] == 0).all())  # zero rows, zero Q rows
    for t in range(B):
        assert validation.orthogonality(qt[t].T) < 1e-6
        assert validation.residual(a[t], qt[t].T, r[t]) < 1e-6


def test_plain_version_at_the_kernels_block_and_modes():
    a = torch.from_numpy(_tiles(1))
    q16, r16 = panel_kernel.panel_qr_reference(a, "fp32")
    q8, r8 = panel_kernel.panel_qr_reference(a, "fp32", block=8)
    assert _rel(r16, r8) <= 1e-6 and _rel(q16, q8) <= 1e-6
    for mode, tol in (("bf16x3_cor", 1e-4), ("bf16", 5e-2)):
        qt, r = panel_kernel.panel_qr_reference(a, mode)
        assert validation.orthogonality(qt[0].T) < tol
        assert validation.residual(a[0], qt[0].T, r[0]) < tol


def test_wrapper_runs_the_plain_version_on_a_cpu_tensor():
    a = torch.from_numpy(_tiles(2))
    launches = trace.counts("launches.")["panel_qr"]
    qt, r = panel_kernel.panel_qr_batched(a, "bf16x6_cor")
    qt0, r0 = panel_kernel.panel_qr_reference(a, "bf16x6_cor")
    assert trace.counts("launches.")["panel_qr"] == launches
    assert torch.equal(qt, qt0) and torch.equal(r, r0)
    with pytest.raises(ValueError, match="in-kernel mode"):
        panel_kernel.panel_qr_batched(a, "mixed_cor_emu")
    with pytest.raises(ValueError, match="batch"):
        panel_kernel.panel_qr_batched(a[0], "fp32")
    with pytest.raises(ValueError, match="tall"):
        panel_kernel.panel_qr_batched(a.transpose(1, 2), "fp32")


def test_kernel_range_from_its_shared_memory():
    # the kernel's footprint: the float32 tile at row stride
    # round_up(L, 32) + 8 and one block's Y in bf16 parts, plus what does
    # not grow with L; 227 KiB per block, and at most two rows a thread
    # (L_MAX) in the column chain.  Tier 4 needs (256, 128) leaves.
    assert panel_kernel.max_leaf_rows(128) == 288
    assert panel_kernel.max_leaf_rows(64) == panel_kernel.L_MAX == 512
    for n in (1, 50, 64, 128):
        lm = panel_kernel.max_leaf_rows(n)
        assert lm % 8 == 0 and lm >= 2 * n and lm <= panel_kernel.L_MAX
        assert panel_kernel.smem_bytes(lm, n) <= 232448
        assert (lm == panel_kernel.L_MAX
                or panel_kernel.smem_bytes(lm + 8, n) > 232448)
    with pytest.raises(ValueError, match="n <= 128"):
        panel_kernel.max_leaf_rows(129)


@pytest.mark.parametrize("batched", [False, True])
def test_panel_qr_facade_matches_jax(batched):
    a = _tiles(3) if batched else _tiles(3)[0]
    q, r = panel_qr.panel_qr(torch.from_numpy(a), "bf16x6_cor", device="cpu")
    qj, rj = jpanel_qr.panel_qr(jnp.asarray(a), "bf16x6_cor")
    assert q.shape == a.shape and q.dtype == torch.float32
    assert _rel(r, rj) <= 1e-5 and _rel(q, qj) <= 1e-5
    qb, rb = panel_qr.panel_qr(torch.from_numpy(a), "bf16", device="cpu")
    assert qb.dtype == rb.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="expected"):
        panel_qr.panel_qr(torch.zeros(2, 2, 8, 4), device="cpu")


# clusters of k the card runs at once: an H100's answer at (256, 128) and
# (288, 128) (cudaOccupancyMaxActiveClusters, NVIDIA H100 80GB HBM3; its
# GPCs leave SMs over at k = 4 and 8)
def _h100(k, L, n):
    return {2: 66, 4: 30, 8: 15}[k]


@pytest.mark.parametrize("batch", [128, 4096, 67, 100])
def test_cluster_size_is_one_past_a_wave(batch):
    # a launch of 67 or more (256, 128) tiles fills a wave of clusters of
    # two: it runs a CTA a tile, as before
    assert panel_kernel.cluster_size(batch, 256, 128, _h100) == 1


@pytest.mark.parametrize("batch,k", [(1, 8), (2, 8), (8, 8), (15, 8),
                                     (16, 4), (30, 4), (31, 2), (32, 2),
                                     (64, 2), (66, 2)])
def test_cluster_size_spreads_a_small_launch(batch, k):
    # the largest k whose clusters the card runs at once: block8192.well's
    # levels of 64, 32, 16, 8 ... 1 nodes take 2, 2, 4, 8 ... 8
    assert panel_kernel.cluster_size(batch, 256, 128, _h100) == k


@pytest.mark.parametrize("n,k", [(128, 8), (100, 4), (64, 4),
                                 (50, 4), (48, 2), (32, 2), (17, 2),
                                 (16, 1), (1, 1)])
def test_cluster_size_at_most_the_tiles_blocks(n, k):
    # a CTA holds at least one 16-column W-Y block: k <= ceil(n / 16)
    assert panel_kernel.cluster_size(1, 2 * n, n, _h100) == k


def test_cluster_size_reads_only_its_arguments_and_falls_with_batch():
    asked = []

    def clusters(k, L, n):
        asked.append((k, L, n))
        return {2: 40, 4: 20, 8: 0}[k]  # no cluster of 8 fits

    ks = [panel_kernel.cluster_size(b, 288, 128, clusters)
          for b in range(1, 200)]
    assert all(x >= y for x, y in zip(ks, ks[1:]))  # monotone in batch
    assert ks[0] == 4 and ks[19] == 4 and ks[20] == 2 and ks[40] == 1
    assert {a[1:] for a in asked} == {(288, 128)}
    assert {a[0] for a in asked} <= set(panel_kernel.CLUSTER_SIZES)
    assert ks == [panel_kernel.cluster_size(b, 288, 128, clusters)
                  for b in range(1, 200)]
    # nothing fits: one CTA a tile, whatever the batch
    assert panel_kernel.cluster_size(1, 288, 128, lambda k, L, n: 0) == 1


@pytest.mark.parametrize("n", [17, 50, 64, 100, 128])
def test_cluster_path_fits_shared_memory(n):
    # every k the tile's blocks allow fits at L = 256 rows, and at the
    # tallest tile but for clusters of two at n = 100, where the path
    # takes k >= 4 or a CTA a tile
    lm = panel_kernel.max_leaf_rows(n)
    for k in panel_kernel.CLUSTER_SIZES:
        if k > -(-n // panel_kernel.BLOCK):
            continue
        smem = panel_kernel.cluster_smem_bytes(max(256, n), n, k)
        assert smem <= 232448
        tall = panel_kernel.cluster_smem_bytes(lm, n, k)
        assert (tall <= 232448) == (n != 100 or k != 2), (n, k, tall)


def test_panel_span_names_its_cluster():
    a = torch.from_numpy(_tiles(4))
    with trace.collect() as col:
        panel_kernel.panel_qr_batched(a, "fp32")
    (sp,) = [s for s in col.spans if s.name == "panel"]
    assert sp.attrs == {"kernel": "panel_qr", "batch": B, "L": L, "n": N,
                        "cluster": 1}
