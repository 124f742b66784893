"""The port's CholeskyQR pipelines against the JAX package's fused methods
(interpret mode), on the same numpy latms inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsqr_tpu.core import auto as jauto
from tsqr_tpu.core import cholqr as jcholqr
from tsqr_tpu_torch.core import auto, cholqr
from tsqr_tpu_torch.utils import latms, validation

torch.set_num_threads(2)

SHAPES = [(4096, 64), (2048, 128)]


def _matrix(m, n, kappa):
    if kappa == 1:
        rng = np.random.default_rng(m + n)
        return rng.uniform(-1, 1, (m, n)).astype(np.float32)
    return latms.rand_matrix_with_cond(m + n, m, n, kappa)[0]


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _gram_orth(g) -> float:
    g = np.asarray(g, np.float64)
    return float(np.linalg.norm(g - np.eye(g.shape[0]))
                 / np.sqrt(g.shape[0]))


@pytest.mark.parametrize("kappa", [1, 1e3])
@pytest.mark.parametrize("m,n", SHAPES)
def test_cholqr1_fused_matches_jax(m, n, kappa):
    a = _matrix(m, n, kappa)
    q, r, gq = cholqr.cholqr1_fused(torch.from_numpy(a), "bf16x6_cor",
                                    return_qgram=True)
    qj, rj, gqj = jcholqr.cholqr1_fused(jnp.asarray(a), "bf16x6_cor",
                                        interpret=True, return_qgram=True)
    orth, orth_j = validation.orthogonality(q), validation.orthogonality(qj)
    if kappa == 1:
        assert _rel(r, rj) <= 1e-5
        assert _rel(q, qj) <= 1e-5
    else:
        # one Cholesky of G amplifies the two Grams' ~1e-7 difference by
        # ~kappa^2: R differs at 1e-4 (measured), so the port is held to
        # JAX's orthogonality grade instead (its 16-row Kahan Gram is the
        # more accurate of the two, so it may do better)
        assert orth < 3 * orth_j
    # the free Q-Gram reports the true orthogonality
    assert abs(_gram_orth(gq) - orth) <= 1e-6 + 0.1 * orth
    assert abs(_gram_orth(gqj) - orth_j) <= 1e-6 + 0.1 * orth_j


@pytest.mark.parametrize("kappa", [1, 1e3, 1e5])
@pytest.mark.parametrize("m,n", SHAPES)
def test_cholqr3_compact_hooks_match_jax(m, n, kappa):
    # the ladder's tier-2 call: g1 (the tier-0 Gram) and the free Q-Gram
    a = _matrix(m, n, kappa)
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    g = cholqr.gram_stream.gram_stream(at, "bf16x6_cor")
    gj = jcholqr.modes.gram(aj, jcholqr.modes.resolve("bf16x6_cor"))
    q, r, gq = cholqr.cholqr3_fused(at, "bf16x6_cor", variant="compact",
                                    g1=g, return_qgram=True)
    qj, rj, gqj = jcholqr.cholqr3_fused(aj, "bf16x6_cor", interpret=True,
                                        variant="compact", g1=gj,
                                        return_qgram=True)
    tol = auto._TOL[cholqr.M.BF16X6_COR]
    gate, gate_j = _gram_orth(gq), _gram_orth(gqj)
    if kappa <= 1e3:
        assert _rel(r, rj) <= 1e-5
        orth = validation.orthogonality(q)
        assert orth < 1e-6 and validation.orthogonality(qj) < 1e-6
        assert abs(gate - orth) <= 1e-6 + 0.1 * orth
        assert validation.residual(a, q, r) < 1e-5
    else:
        # past cholqr3's ~1e4 contract both pipelines break down, and
        # both gates say so (NaN or above tolerance): the ladder's
        # tier-2 decision is the same
        assert not gate < tol and not gate_j < tol


def test_cholqr3_safe_bf16_matches_jax():
    m, n = SHAPES[1]
    a = _matrix(m, n, 1)
    ab = np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    q, r = cholqr.cholqr3_fused(torch.from_numpy(ab).bfloat16(), "bf16")
    qj, rj = jcholqr.cholqr3_fused(jnp.asarray(ab).astype(jnp.bfloat16),
                                   "bf16", interpret=True)
    assert q.dtype == r.dtype == torch.bfloat16
    # three chained bf16 products, each rounded to 2^-8 on its own in
    # either package: R and Q differ at 4-5e-3 (measured), and both land
    # on the same bf16 orthogonality grade
    assert _rel(r.float(), np.asarray(rj, np.float32)) <= 1e-2
    assert _rel(q.float(), np.asarray(qj, np.float32)) <= 1e-2
    orth = validation.orthogonality(q)
    assert orth < 2 * validation.orthogonality(np.asarray(qj, np.float32))
    assert orth < auto._TOL[cholqr.M.BF16]


@pytest.mark.parametrize("variant", ["safe", "fastest"])
def test_cholqr3_write_q_variants_match_jax(variant):
    m, n = SHAPES[0]
    a = _matrix(m, n, 1e3 if variant == "safe" else 1)
    q, r = cholqr.fastqr(torch.from_numpy(a), "fp32", "cholqr3_fused",
                         variant, device="cpu")
    qj, rj = jcholqr.cholqr3_fused(jnp.asarray(a), "fp32", interpret=True,
                                   variant=variant)
    assert _rel(r, rj) <= 1e-5
    assert validation.orthogonality(q) < 1e-6


@pytest.mark.parametrize("kappa", [1e3, 1e5])
@pytest.mark.parametrize("m,n", SHAPES)
def test_cholqr_iter_fused_matches_jax(m, n, kappa):
    a = _matrix(m, n, kappa)
    q, r, gq = cholqr.cholqr_iter_fused(torch.from_numpy(a), "bf16x6_cor",
                                        return_qgram=True)
    qj, rj, _ = jcholqr.cholqr_iter_fused(jnp.asarray(a), "bf16x6_cor",
                                          interpret=True, return_qgram=True)
    orth = validation.orthogonality(q)
    assert orth < auto._TOL[cholqr.M.BF16X6_COR]
    assert validation.orthogonality(qj) < auto._TOL[cholqr.M.BF16X6_COR]
    assert _gram_orth(gq) < auto._TOL[cholqr.M.BF16X6_COR]
    assert validation.residual(a, q, r) < 1e-5
    if kappa <= 1e3:
        assert _rel(r, rj) <= 1e-5


def test_k2_bound_matches_jax():
    a = _matrix(2048, 128, 1e3)
    g = a.T.astype(np.float32) @ a
    k2 = float(cholqr._k2_of_gram(torch.from_numpy(g)))
    k2j = float(np.asarray(jauto.cholqr._k2_of_gram(jnp.asarray(g))).ravel()[0])
    # the bound inverts G: the two Choleskys' rounding moves it ~1 %
    assert abs(k2 - k2j) <= 0.05 * k2j
    assert k2 >= 0.9e6  # never under-reports kappa^2


def test_iter_loop_ends_on_a_singular_gram_like_jax():
    # a zero column: the unshifted Cholesky fails on every pass, so the
    # k2 exit signal stays NaN and the measured orthogonality stays far
    # from _ORTH_EXIT; both host loops stop at max_shifted, and the tail
    # Cholesky's NaN is what sends the ladder on to tier 4
    a = _matrix(2048, 64, 1)
    a[:, 9] = 0.0
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    n, max_shifted = 64, 16

    def run(mod, x, t):
        g0 = t(x.T @ x)
        out = mod._iter_shifted_loop(
            g0, lambda f: (x @ f).T @ (x @ f),
            lambda g: mod._shift_value_fused(g, n, 16), n,
            0.1 / 6e-8, max_shifted)
        return int(out[3]), out[2]

    passes, g = run(cholqr, at, lambda g: g)
    passes_j, g_j = run(jcholqr, aj, lambda g: g)
    assert passes == passes_j == max_shifted
    assert torch.isnan(cholqr._chol_r(g)).any()
    assert bool(jnp.isnan(jcholqr._chol_r(g_j)).any())


def test_chol_r_returns_nan_on_indefinite():
    g = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    r = cholqr._chol_r(g, shift=None)
    assert torch.isnan(r).all()
    assert torch.isfinite(cholqr._chol_r(torch.eye(2) * 4)).all()


def test_unported_paths_raise():
    # every method of the JAX package is ported now; what still raises is
    # what the JAX package refuses too
    a = torch.from_numpy(_matrix(256, 64, 1))
    with pytest.raises(ValueError, match="unknown method"):
        cholqr.fastqr(a, "fp32", method="cholqr4", device="cpu")
    with pytest.raises(ValueError, match="fused-kernel range"):
        cholqr.cholqr1_fused(torch.zeros(2064, 2056), "fp32",
                             return_qgram=True)
    with pytest.raises(ValueError, match="m >= n"):
        cholqr.fastqr(a.T.contiguous(), "fp32", method="cholqr1_fused",
                      device="cpu")
    with pytest.raises(ValueError, match="cheap-dot"):
        cholqr.cholqr3_fused(a, "bf16", variant="compact")
    with pytest.raises(ValueError):
        cholqr.cholqr_iter_fused(a, "bf16_nocor")
    with pytest.raises(ValueError, match="cheap-dot"):
        cholqr.cholqr_iter(a, "bf16")
