"""The port's Householder QR (the tree's inner nodes) against the JAX
package's, on the same numpy panels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu import modes as jmodes
from tsqr_tpu.ops import householder as jhh
from tsqr_tpu_torch import modes
from tsqr_tpu_torch.ops import householder
from tsqr_tpu_torch.utils import validation


SHAPES = [(96, 24), (128, 32), (64, 16)]


def _panel(m, n, seed=0):
    return np.random.default_rng(seed + m + n).uniform(
        -1, 1, (m, n)).astype(np.float32)


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
@pytest.mark.parametrize("m,n", SHAPES)
def test_householder_matches_jax(m, n, mode, blocked):
    a = _panel(m, n)
    a[:, n // 2] = 0.0  # a zero column passes through as H = I
    if blocked:
        q, r = householder.blocked_householder_qr(
            torch.from_numpy(a), modes.resolve(mode).mm, block=8)
        qj, rj = jhh.blocked_householder_qr(
            jnp.asarray(a), jmodes.resolve(mode).mm, block=8)
    else:
        q, r = householder.householder_qr(torch.from_numpy(a),
                                          modes.resolve(mode).mm)
        qj, rj = jhh.householder_qr(jnp.asarray(a), jmodes.resolve(mode).mm)
    # the same reflectors and sign convention, summed in other orders:
    # Q and R of these well-conditioned panels agree to float32 grade
    assert _rel(r, rj) <= 1e-5
    assert _rel(q, qj) <= 1e-5
    rn = r.numpy()
    assert np.array_equal(np.triu(rn), rn)
    assert np.all(np.diag(rn)[:n // 2] * np.diag(np.asarray(rj))[:n // 2]
                  > 0)
    assert validation.orthogonality(q) < 1e-6
    assert validation.residual(a, q, r) < 1e-6


def test_householder_batches_like_a_loop():
    # the leading axis takes the place of the reference's vmap
    a = np.stack([_panel(64, 16, s) for s in range(3)])
    q, r = householder.blocked_householder_qr(torch.from_numpy(a))
    for t in range(3):
        qt, rt = householder.blocked_householder_qr(torch.from_numpy(a[t]))
        assert _rel(q[t], qt) <= 1e-6 and _rel(r[t], rt) <= 1e-6


def test_house_vector_sign_convention():
    # R_jj = -sign(x_j) ||x|| with sign(0) = +1; beta = 0 on a zero column
    x = torch.tensor([[0.0, 3.0, 4.0], [0.0, -3.0, 4.0], [0.0, 0.0, 0.0]])
    v, beta, alpha = householder._house_vector(x, 1)
    assert alpha.tolist() == [-5.0, 5.0, -0.0]
    assert v[0].tolist() == [0.0, 8.0, 4.0]
    assert beta[2] == 0.0 and beta[0] == pytest.approx(2.0 / 80.0)


def test_qr_sign_normalize_matches_jax():
    a = _panel(64, 16)
    q, r = householder.householder_qr(torch.from_numpy(a))
    qs, rs = householder.qr_sign_normalize(q, r)
    qj, rj = jhh.qr_sign_normalize(*jhh.householder_qr(jnp.asarray(a)))
    assert bool((torch.diagonal(rs) >= 0).all())
    assert _rel(rs, rj) <= 1e-5 and _rel(qs, qj) <= 1e-5
    assert validation.residual(a, qs, rs) < 1e-6
