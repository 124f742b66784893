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
