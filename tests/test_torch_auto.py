"""The whole slice: the port's predictive ladder against the JAX
package's qr_auto_fused (its CPU route), on the same numpy inputs, and the
port's rule that its entry points run on the card unless asked for the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsqr_tpu_torch
from tsqr_tpu.core import auto as jauto
from tsqr_tpu_torch.core import auto
from tsqr_tpu_torch.ops import panel_kernel
from tsqr_tpu_torch.utils import latms, validation

torch.set_num_threads(2)

M, N = 4096, 128


def _matrix(kappa):
    if kappa == 1:
        rng = np.random.default_rng(7)
        return rng.uniform(-1, 1, (M, N)).astype(np.float32)
    return latms.rand_matrix_with_cond(int(kappa), M, N, kappa)[0]


@pytest.mark.parametrize("kappa", [1, 1e3, 2 ** 18])
@pytest.mark.parametrize("mode", ["bf16x6_cor", "fp32"])
def test_ladder_matches_jax(mode, kappa):
    a = _matrix(kappa)
    q, r, info = auto.qr_auto_fused(torch.from_numpy(a), mode,
                                    return_info=True, device="cpu")
    qj, rj, infoj = jauto.qr_auto_fused(jnp.asarray(a), mode,
                                        return_info=True)
    tier_j = int(np.asarray(infoj["tier"]).ravel()[0])
    if mode == "fp32" and kappa == 2 ** 18:
        # the port's fused pipelines may stop on another rung than JAX's
        # non-fused CPU route; both must escalate past tier 1
        assert info["tier"] in (2, 3)
    else:
        assert info["tier"] == tier_j
    assert tuple(info["kappa2_est"].shape) == (1, 1)
    k2, k2j = float(info["kappa2_est"]), float(np.asarray(
        infoj["kappa2_est"]).ravel()[0])
    if np.isfinite(k2j) and kappa <= 1e3:
        assert k2 >= 0.9 * kappa ** 2 and abs(k2 - k2j) <= 0.2 * k2j
    tol = auto._TOL[auto.M(mode)]
    qn, rn = q.numpy(), r.numpy()
    assert validation.orthogonality(qn) < tol
    assert validation.orthogonality(np.asarray(qj)) < tol
    assert validation.residual(a, qn, rn) < tol
    assert np.array_equal(np.triu(rn), rn)
    if kappa == 1:
        rj64 = np.asarray(rj, np.float64)
        assert np.linalg.norm(rn - rj64) / np.linalg.norm(rj64) <= 1e-5


@pytest.mark.parametrize("mode", ["bf16x6_cor", "fp32"])
def test_rank_deficient_input_takes_tier4(mode):
    # a zero column defeats every Gram tier (tests/test_ooc_auto.py's
    # forced-tier-4 input): both ladders end on the Householder tree
    a = _matrix(1)
    a[:, 33] = 0.0
    launches = panel_kernel.LAUNCHES
    q, r, info = auto.qr_auto_fused(torch.from_numpy(a), mode,
                                    return_info=True, device="cpu")
    qj, rj, infoj = jauto.qr_auto_fused(jnp.asarray(a), mode,
                                        return_info=True)
    assert info["tier"] == 4
    assert int(np.asarray(infoj["tier"]).ravel()[0]) == 4
    assert panel_kernel.LAUNCHES == launches  # the plain leaf on the CPU
    tol = auto._TOL[auto.M(mode)]
    qn, rn = q.numpy(), r.numpy()
    assert validation.orthogonality(qn) < tol
    assert validation.residual(a, qn, rn) < tol
    assert validation.orthogonality(np.asarray(qj)) < tol
    assert np.array_equal(np.triu(rn), rn) and rn[33, 33] == 0.0
    # R past the zero column depends on the tree (Q's column 33 is any
    # unit vector orthogonal to the rest), but R^T R = A^T A does not.
    # Both trees hold it to the grade of their residual (measured 3.3e-6
    # at bf16x6_cor, 7e-7 at fp32, in either package), so the port is
    # held to twice JAX's error
    a64 = a.astype(np.float64)
    g = a64.T @ a64

    def gram_err(rr):
        rr = np.asarray(rr, np.float64)
        return np.linalg.norm(rr.T @ rr - g) / np.linalg.norm(g)

    assert gram_err(rn) <= 2 * gram_err(rj)


def test_ladder_bf16_matches_jax_tier():
    # bf16's gate admits tier 1 only below kappa^2 ~ 1.6, so a uniform
    # input takes the cheap-mode tier 2 in both packages
    a = _matrix(1)
    q, r, info = auto.qr_auto_fused(torch.from_numpy(a).bfloat16(), "bf16",
                                    return_info=True, device="cpu")
    _, _, infoj = jauto.qr_auto_fused(jnp.asarray(a).astype(jnp.bfloat16),
                                      "bf16", return_info=True)
    assert info["tier"] == int(np.asarray(infoj["tier"]).ravel()[0])
    assert q.dtype == r.dtype == torch.bfloat16
    assert validation.orthogonality(q) < auto._TOL[auto.M.BF16]
    # the non-fused methods take the same tier as in the JAX package
    _, _, info = auto.qr_auto_fused(torch.from_numpy(a), "fp32",
                                    fast_method="cholqr1",
                                    mid_method="cholqr3", return_info=True,
                                    device="cpu")
    _, _, infoj = jauto.qr_auto_fused(jnp.asarray(a), "fp32",
                                      fast_method="cholqr1",
                                      mid_method="cholqr3", return_info=True)
    assert info["tier"] == int(np.asarray(infoj["tier"]).ravel()[0]) == 1


@pytest.mark.parametrize("kappa", [1, 1e3, 2 ** 18])
def test_ladder_past_the_kernel_range_matches_jax_tier(kappa):
    # n = 200 > 128: the port's ladder runs its fused pipelines (the wide
    # kernels' range, their plain version on the CPU), the JAX package's
    # its non-fused ones off the TPU; both take the same tier
    m, n = 2048, 200
    a = (np.random.default_rng(3).uniform(-1, 1, (m, n)).astype(np.float32)
         if kappa == 1 else latms.rand_matrix_with_cond(9, m, n, kappa)[0])
    q, r, info = auto.qr_auto_fused(torch.from_numpy(a), "bf16x6_cor",
                                    return_info=True, device="cpu")
    _, _, infoj = jauto.qr_auto_fused(jnp.asarray(a), "bf16x6_cor",
                                      return_info=True)
    assert info["tier"] == int(np.asarray(infoj["tier"]).ravel()[0])
    assert validation.orthogonality(q) < 1e-5
    assert validation.residual(a, q.numpy(), r.numpy()) < 1e-5


@pytest.mark.parametrize("case", ["uniform", "kappa1e5", "zero_column"])
def test_qr_auto_takes_jax_method(case):
    m, n = 2048, 64
    a = (latms.rand_matrix_with_cond(11, m, n, 1e5)[0] if case == "kappa1e5"
         else np.random.default_rng(5).uniform(-1, 1, (m, n)).astype(
             np.float32))
    if case == "zero_column":
        a[:, 33] = 0.0
    # bf16x6_cor: at kappa = 1e5, past cholqr3's kappa <~ 2e4, its
    # Cholesky breaks down in both packages and both retry with
    # cholqr_iter.  (In fp32 mode the breakdown at that kappa hangs on the
    # Grams' summation order: the packages part ways, measured.)
    q, r, used = tsqr_tpu_torch.qr_auto(torch.from_numpy(a), "bf16x6_cor",
                                        device="cpu")
    _, _, used_j = jauto.qr_auto(jnp.asarray(a), "bf16x6_cor")
    assert used == used_j == {"uniform": "cholqr3", "kappa1e5": "cholqr_iter",
                              "zero_column": "blockqr_tsqr"}[case]
    assert validation.orthogonality(q) < 1e-5
    assert validation.residual(a, q, r) < 1e-5


ENTRY_POINTS = {
    "qr_auto_fused": lambda a, **kw: tsqr_tpu_torch.qr_auto_fused(a, **kw),
    "fastqr": lambda a, **kw: tsqr_tpu_torch.fastqr(a, "fp32",
                                                    "cholqr1_fused", **kw),
    "qr_auto": lambda a, **kw: tsqr_tpu_torch.qr_auto(a, **kw),
    # on a copy: the caller's tensor holds Q afterwards
    "fastqr_inplace": lambda a, **kw: tsqr_tpu_torch.fastqr_inplace(
        a.clone(), "fp32", **kw),
    "tsqr": lambda a, **kw: tsqr_tpu_torch.tsqr(a, **kw),
    "qr": lambda a, **kw: tsqr_tpu_torch.qr(a, **kw),
    "panel_qr": lambda a, **kw: tsqr_tpu_torch.panel_qr(a, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_unless_asked(name, monkeypatch):
    # without a card, an entry point called without device="cpu" raises
    # instead of carrying on on the CPU; with device="cpu" it runs there
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (300, 12)).astype(np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](a)
    q, r = ENTRY_POINTS[name](a, device="cpu")[:2]
    assert q.device.type == r.device.type == "cpu"
    assert validation.orthogonality(q) < 1e-5
    assert validation.residual(a, q, r) < 1e-5
