"""The whole slice: the port's predictive ladder against the JAX
package's qr_auto_fused (its CPU route), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsqr_tpu.core import auto as jauto
from tsqr_tpu_torch.core import auto
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
                                    return_info=True)
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


def test_rank_deficient_input_raises_tier4():
    a = _matrix(1)
    a[:, 17] = 0.0
    with pytest.raises(NotImplementedError, match="tier 4"):
        auto.qr_auto_fused(torch.from_numpy(a), "bf16x6_cor")


def test_ladder_bf16_matches_jax_tier():
    # bf16's gate admits tier 1 only below kappa^2 ~ 1.6, so a uniform
    # input takes the cheap-mode tier 2 in both packages
    a = _matrix(1)
    q, r, info = auto.qr_auto_fused(torch.from_numpy(a).bfloat16(), "bf16",
                                    return_info=True)
    _, _, infoj = jauto.qr_auto_fused(jnp.asarray(a).astype(jnp.bfloat16),
                                      "bf16", return_info=True)
    assert info["tier"] == int(np.asarray(infoj["tier"]).ravel()[0])
    assert q.dtype == r.dtype == torch.bfloat16
    assert validation.orthogonality(q) < auto._TOL[auto.M.BF16]
    with pytest.raises(NotImplementedError, match="ROADMAP A.3"):
        auto.qr_auto_fused(torch.from_numpy(a), "fp32", fast_method="cholqr1")
