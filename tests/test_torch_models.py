"""The port's models (tsqr_tpu_torch/models) against the JAX package's
(tsqr_tpu/models), on the CPU, on the same numpy inputs.

Deterministic models are compared with JAX's values directly.  A random
model draws through one small function of its module (``_normal``, or
``qrcp._sketch``); a test replaces it with the JAX package's own draw for
the same key, so the two packages' values can be compared too, and the
JAX tests' statistical contracts are held with the port's own
``torch.Generator``.  Only what is unique is compared: singular values,
eigenvalues and correlations, products (U diag(s) V^T, U H,
a[:, cols] @ coeff) and subspaces, never raw singular or eigenvectors.
Tolerances are core/auto.py ``_TOL`` of the mode unless a case says
otherwise.  The mesh routes are ROADMAP A.7's (tests/test_torch_hygiene.py
pins their NotImplementedError).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
import tsqr_tpu.models as jm
import tsqr_tpu_torch.models as tm
from tsqr_tpu.core import cholqr as jcholqr
from tsqr_tpu_torch.core import auto
from tsqr_tpu_torch.utils import latms


# the packages re-export functions under their modules' names
MODULES = {name: (importlib.import_module(f"tsqr_tpu_torch.models.{name}"),
                  importlib.import_module(f"tsqr_tpu.models.{name}"))
           for name in ("rsvd", "lanczos", "lstsq", "qrcp", "polar",
                        "subspace", "cca")}
CPU = dict(device="cpu")


def _tol(mode="fp32") -> float:
    return auto._TOL[auto.M(mode)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def _rel(x, ref) -> float:
    x, ref = _np(x), _np(ref)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _rand(m, n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (m, n)).astype(
        np.float32)


def _proj_dist(u, v) -> float:
    """Spectral distance of the projectors onto span(u) and span(v)."""
    u, v = np.linalg.qr(_np(u))[0], np.linalg.qr(_np(v))[0]
    return float(np.linalg.norm(u @ u.T - v @ v.T, 2))


def _orth(u) -> float:
    u = _np(u)
    k = u.shape[1]
    return float(np.linalg.norm(u.T @ u - np.eye(k)) / np.sqrt(k))


# ---- the draw seam -------------------------------------------------------

@pytest.fixture
def jax_draws(monkeypatch):
    """Replace a module's draw by the JAX package's for ``key``: the
    models' ``_normal(gen, shape, device)`` by ``jax.random.normal(key)``
    (``step``: each successive draw takes ``fold_in(key, j)``, j advancing
    by ``step``, as lstsq_cgls's sketch blocks), and ``qrcp._sketch`` by
    ``sketch_gaussian`` with ``key``, then ``fold_in(key, 1)``."""

    def patch(name, key, step=None):
        mod = MODULES[name][0]
        if name == "qrcp":
            keys = iter([key, jax.random.fold_in(key, 1)])

            def sketch(a, gen, l):
                b = jcholqr.sketch_gaussian(jnp.asarray(_np(a), jnp.float32),
                                            next(keys), l)
                return _t(b)

            monkeypatch.setattr(mod, "_sketch", sketch)
            return
        j = [0]

        def normal(gen, shape, device):
            k = key if step is None else jax.random.fold_in(key, j[0])
            j[0] += step or 0
            return _t(jax.random.normal(k, shape, jnp.float32))

        monkeypatch.setattr(mod, "_normal", normal)

    return patch


# ---- tsqr_svd ---------------------------------------------------------------

@pytest.mark.parametrize("mode,method", [("fp32", "cholqr2"),
                                         ("bf16x6_cor", "cholqr3")])
def test_tsqr_svd_matches_jax(mode, method):
    a = _rand(1024, 24, 5)
    u, s, vt = tm.tsqr_svd(_t(a), mode, method=method, **CPU)
    uj, sj, vtj = jm.tsqr_svd(jnp.asarray(a), mode, method=method)
    assert _rel(s, sj) <= _tol(mode)
    rec, rec_j = (_np(u) * _np(s)) @ _np(vt), (_np(uj) * _np(sj)) @ _np(vtj)
    assert _rel(rec, rec_j) <= _tol(mode)
    sg = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(_np(s), sg, rtol=1e-5)
    assert _rel(rec, a) < 1e-6 and _orth(u) < 1e-5
    with pytest.raises(ValueError):
        tm.tsqr_svd(torch.ones(8, 16), **CPU)


# ---- lstsq --------------------------------------------------------------------

@pytest.mark.parametrize("rhs,ridge", [(1, 0.0), (3, 0.0), (1, 0.37),
                                       (3, 100.0)])
def test_lstsq_matches_jax(rhs, ridge):
    rng = np.random.default_rng(3 + rhs)
    a = rng.uniform(-1, 1, (256, 32)).astype(np.float32)
    b = rng.uniform(-1, 1, (256, rhs)).astype(np.float32)
    b = b[:, 0] if rhs == 1 else b
    x = tm.lstsq(_t(a), _t(b), ridge=ridge, leaf_rows=128, **CPU)
    xj = jm.lstsq(jnp.asarray(a), jnp.asarray(b), ridge=ridge, leaf_rows=128)
    assert tuple(x.shape) == tuple(xj.shape) and _rel(x, xj) <= _tol()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    x64 = np.linalg.solve(a64.T @ a64 + ridge * np.eye(32), a64.T @ b64)
    np.testing.assert_allclose(_np(x), x64, rtol=0, atol=1e-4)


def test_lstsq_ridge_zero_shrinks_and_raises():
    rng = np.random.default_rng(1)
    a = _t(rng.uniform(-1, 1, (256, 16)))
    b = _t(rng.uniform(-1, 1, (256, 3)))
    x0 = tm.lstsq(a, b, **CPU)
    assert torch.equal(x0, tm.lstsq(a, b, ridge=0.0, **CPU))
    norms = [float(torch.linalg.norm(tm.lstsq(a, b, ridge=lam, **CPU)))
             for lam in (0.0, 1.0, 100.0)]
    assert norms[0] > norms[1] > norms[2]
    with pytest.raises(ValueError, match="ridge"):
        tm.lstsq(a, b, ridge=-1.0, **CPU)


def test_lstsq_ridge_regularizes_ill_conditioned():
    a, _ = latms.rand_matrix_with_cond(2, 2048, 32, 1e6)
    b = np.random.default_rng(3).uniform(-1, 1, 2048).astype(np.float32)
    x = tm.lstsq(_t(a), _t(b), ridge=1e-2, **CPU)
    xj = jm.lstsq(jnp.asarray(a), jnp.asarray(b), ridge=1e-2)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    x64 = np.linalg.solve(a64.T @ a64 + 1e-2 * np.eye(32), a64.T @ b64)
    assert _rel(x, x64) < 1e-3 and _rel(x, xj) < 1e-3


def test_lstsq_grad_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(-1, 1, (192, 12)).astype(np.float32)
    b = rng.uniform(-1, 1, (192, 2)).astype(np.float32)
    w = rng.uniform(-1, 1, (12, 2)).astype(np.float32)
    at = _t(a).requires_grad_()
    loss = (tm.lstsq(at, _t(b), leaf_rows=64, **CPU) * _t(w)).sum()
    (g,) = torch.autograd.grad(loss, at)
    g_j = jax.grad(lambda x: jnp.sum(
        jm.lstsq(x, jnp.asarray(b), leaf_rows=64) * w))(jnp.asarray(a))
    assert _rel(g, g_j) <= _tol()


# ---- polar / procrustes ----------------------------------------------------

def _check_polar(a, u, h, tol):
    un, hn = _np(u), _np(h)
    assert _orth(un) < tol
    assert np.allclose(hn, hn.T)
    assert np.linalg.eigvalsh(hn).min() > -1e-5 * np.linalg.norm(hn, 2)
    assert _rel(un @ hn, a) < tol


@pytest.mark.parametrize("case", ["uniform", "kappa1e2", "kappa1e5",
                                  "bf16x6_cor_cholqr3"])
def test_polar_matches_jax(case):
    kw, mode = {}, "fp32"
    if case == "uniform":
        a = _rand(2048, 48, 0)
    elif case.startswith("kappa"):
        kappa = float(case[5:])
        a = latms.latms(np.random.default_rng(2), 2048, 64,
                        np.linspace(1.0, 1.0 / kappa, 64))
        kw = dict(fast_method="cholqr2", mid_method="cholqr3")
    else:
        a, mode, kw = _rand(1024, 32, 3), "bf16x6_cor", dict(method="cholqr3")
    u, h = tm.polar(_t(a), mode, **kw, **CPU)
    uj, hj = jm.polar(jnp.asarray(a), mode, **kw)
    # the polar factor is unique for full column rank, but its
    # sensitivity grows like kappa (~2 / (s_min + s_next) in each
    # subspace): U is held elementwise at kappa ~ 1 and in the spectral
    # norm at 1e-6 kappa (the JAX test's bound against its SVD golden)
    # past it; H = (A^T A)^(1/2) is well conditioned in A throughout
    kappa = float(case[5:]) if case.startswith("kappa") else 1.0
    if kappa > 1:
        assert np.linalg.norm(_np(u) - _np(uj), 2) < 1e-6 * kappa
    else:
        assert _rel(u, uj) <= _tol(mode)
    assert _rel(h, hj) <= _tol(mode)
    _check_polar(a.astype(np.float64), u, h, 5e-6)
    with pytest.raises(ValueError):
        tm.polar(torch.ones(8, 16), **CPU)


def test_polar_nearest_orthogonal_factor():
    rng = np.random.default_rng(1)
    q_true = np.linalg.qr(rng.standard_normal((1024, 32)))[0]
    b = rng.standard_normal((32, 32))
    h_true = b @ b.T + 32 * np.eye(32)
    u, h = tm.polar(_t(q_true @ h_true), **CPU)
    assert np.linalg.norm(_np(u) - q_true) / np.sqrt(32) < 1e-5
    np.testing.assert_allclose(_np(h), h_true, rtol=1e-4, atol=1e-3)


def test_procrustes_matches_jax_and_recovers_rotation():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4096, 24)).astype(np.float32)
    om_true = np.linalg.qr(rng.standard_normal((24, 24)))[0]
    b = (a @ om_true + 1e-4 * rng.standard_normal((4096, 24))).astype(
        np.float32)
    om = tm.procrustes(_t(a), _t(b), **CPU)
    om_j = jm.procrustes(jnp.asarray(a), jnp.asarray(b))
    assert _rel(om, om_j) <= _tol()
    assert _orth(om) < 1e-6
    assert np.linalg.norm(_np(om) - om_true) / np.sqrt(24) < 1e-3
    with pytest.raises(ValueError):
        tm.procrustes(torch.ones(8, 4), torch.ones(8, 5), **CPU)


def test_procrustes_deficient_rank_contract():
    rng = np.random.default_rng(6)
    u0 = np.linalg.qr(rng.standard_normal((2048, 32)))[0]
    v0 = np.linalg.qr(rng.standard_normal((32, 32)))[0]
    a64 = (u0 * np.logspace(0, -5, 32)) @ v0.T
    b64 = a64 @ np.linalg.qr(rng.standard_normal((32, 32)))[0]
    om = _np(tm.procrustes(_t(a64), _t(b64), **CPU))
    assert np.linalg.norm(a64 @ om - b64) / np.linalg.norm(b64) < 1e-3


# ---- cca ----------------------------------------------------------------------

def _views(m, p, q, seed, shared=2, noise=0.1):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((m, shared))
    x = np.c_[z + noise * rng.standard_normal((m, shared)),
              rng.standard_normal((m, p - shared))]
    y = np.c_[z + noise * rng.standard_normal((m, shared)),
              rng.standard_normal((m, q - shared))]
    return x, y


def _cca64(x, y):
    s = np.linalg.svd(np.linalg.qr(x)[0].T @ np.linalg.qr(y)[0],
                      compute_uv=False)
    return np.clip(s, 0.0, 1.0)


@pytest.mark.parametrize("method,mode", [("tsqr", "fp32"), ("auto", "fp32"),
                                         ("cholqr2", "fp32"),
                                         ("tsqr", "bf16x6_cor")])
def test_cca_matches_jax(method, mode):
    x64, y64 = _views(4096, 16, 12, 9)
    c, wx, wy = tm.cca(_t(x64), _t(y64), mode=mode, method=method, **CPU)
    cj, _, _ = jm.cca(jnp.asarray(x64, jnp.float32),
                      jnp.asarray(y64, jnp.float32), mode=mode, method=method)
    assert _rel(c, cj) <= _tol(mode)
    ref = _cca64(x64, y64)
    np.testing.assert_allclose(_np(c), ref, atol=5e-5)
    u, v = x64 @ _np(wx), y64 @ _np(wy)
    np.testing.assert_allclose(np.linalg.norm(u, axis=0), np.ones(12),
                               atol=1e-4)
    np.testing.assert_allclose(u.T @ v, np.diag(_np(c)), atol=1e-4)


def test_cca_planted_directions_and_invariance():
    x64, y64 = _views(8192, 12, 10, 1, shared=2, noise=0.05)
    c = _np(tm.cca(_t(x64), _t(y64), center=True, **CPU)[0])
    assert np.all(c[:2] > 0.99) and np.all(c[2:] < 0.2)
    assert np.all(np.diff(c) <= 1e-6)
    rng = np.random.default_rng(3)
    tx = rng.standard_normal((12, 12)) + 3 * np.eye(12)
    ty = rng.standard_normal((10, 10)) + 3 * np.eye(10)
    c2 = _np(tm.cca(_t(x64 @ tx), _t(y64 @ ty), center=True, **CPU)[0])
    np.testing.assert_allclose(c, c2, atol=5e-4)


def test_cca_checks_before_work():
    with pytest.raises(ValueError, match="unknown method"):
        # the method is refused before the shapes are looked at
        tm.cca(torch.zeros(64, 4), torch.zeros(32, 4), method="qr9", **CPU)
    with pytest.raises(ValueError, match="observation"):
        tm.cca(torch.zeros(64, 4), torch.zeros(32, 4), **CPU)


def test_cca_grad_matches_jax():
    x64, y64 = _views(1024, 8, 6, 5)
    x, y = x64.astype(np.float32), y64.astype(np.float32)
    xt = _t(x).requires_grad_()
    (g,) = torch.autograd.grad(tm.cca(xt, _t(y), rank=3, **CPU)[0].sum(), xt)
    g_j = jax.grad(lambda v: jm.cca(v, jnp.asarray(y), rank=3)[0].sum())(
        jnp.asarray(x))
    assert bool(torch.isfinite(g).all()) and _rel(g, g_j) <= _tol()


# ---- rsvd / block_lanczos ---------------------------------------------------

def _low_rank(m, n, k, seed):
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((n, k)))[0]
    s = np.linspace(10, 1, k)
    return (u * s) @ v.T, s


def test_rsvd_matches_jax_through_the_draw(jax_draws):
    a, _ = _low_rank(512, 64, 10, 0)
    key = jax.random.PRNGKey(0)
    jax_draws("rsvd", key)
    u, s, vt = tm.rsvd(_t(a), 10, _gen(), leaf_rows=128, **CPU)
    uj, sj, vtj = jm.rsvd(jnp.asarray(a, jnp.float32), rank=10, key=key,
                          leaf_rows=128)
    assert _rel(s, sj) <= _tol()
    assert _rel((_np(u) * _np(s)) @ _np(vt),
                (_np(uj) * _np(sj)) @ _np(vtj)) <= _tol()


def test_rsvd_low_rank_recovery():
    a, s_true = _low_rank(512, 64, 10, 0)
    u, s, vt = tm.rsvd(_t(a), 10, _gen(1), leaf_rows=128, **CPU)
    np.testing.assert_allclose(_np(s), s_true, rtol=1e-3)
    assert _rel((_np(u) * _np(s)) @ _np(vt), a) < 1e-4 and _orth(u) < 1e-5


def _sym(n, spectrum, seed):
    v, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    a64 = (v * spectrum) @ v.T
    return (a64 + a64.T) / 2


def test_block_lanczos_matches_jax_through_the_draw(jax_draws):
    a64 = _sym(128, np.linspace(1, 100, 128), 1)
    at, aj = _t(a64), jnp.asarray(a64, jnp.float32)
    key = jax.random.PRNGKey(2)
    jax_draws("lanczos", key)
    qb, alphas, betas = tm.block_lanczos(lambda x: at @ x, 128, 8, 8, _gen(),
                                         leaf_rows=128, **CPU)
    qj, _, _ = jm.block_lanczos(lambda x: aj @ x, 128, block=8, iters=8,
                                key=key, leaf_rows=128)
    assert tuple(qb.shape) == (128, 64) and tuple(alphas.shape) == (8, 8, 8)
    assert tuple(betas.shape) == (7, 8, 8)
    ritz = np.linalg.eigvalsh(_np(qb).T @ a64 @ _np(qb))
    ritz_j = np.linalg.eigvalsh(_np(qj).T @ a64 @ _np(qj))
    np.testing.assert_allclose(ritz, ritz_j, rtol=0, atol=_tol() * 100)
    assert _proj_dist(qb, qj) < 1e-3


def test_block_lanczos_eigenvalues():
    a64 = _sym(128, np.linspace(1, 100, 128), 1)
    at = _t(a64)
    qb, _, _ = tm.block_lanczos(lambda x: at @ x, 128, 8, 8, _gen(2),
                                leaf_rows=128, **CPU)
    assert np.linalg.norm(_np(qb).T @ _np(qb) - np.eye(64)) < 1e-4
    ritz = np.linalg.eigvalsh(_np(qb).T @ a64 @ _np(qb))
    assert abs(ritz.max() - 100) / 100 < 0.02


# ---- lstsq_cgls --------------------------------------------------------------

def _ops(a):
    at = _t(a)
    return (lambda x: at @ x), (lambda y: at.T @ y)


def _resid_excess(a, b, x):
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    x64 = np.linalg.lstsq(a64, b64, rcond=None)[0]
    return (np.linalg.norm(a64 @ _np(x) - b64)
            / np.linalg.norm(a64 @ x64 - b64) - 1)


def test_cgls_matches_jax_through_the_draw(jax_draws):
    a, _ = latms.rand_matrix_with_cond(4, 2048, 32, 1e2)
    b = np.random.default_rng(5).uniform(-1, 1, 2048).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jax_draws("lstsq", key, step=32)
    x, info = tm.lstsq_cgls(*_ops(a), _t(b), 32, gen=_gen(), tol=1e-6,
                            **CPU)
    aj = jnp.asarray(a)
    xj, info_j = jm.lstsq_cgls(lambda v: aj @ v, lambda v: aj.T @ v,
                               jnp.asarray(b), 32, key=key, tol=1e-6)
    # the same draws: the same iteration count within the rounding of
    # the exit test, and iterates agreeing to the solve's own accuracy,
    # kappa(A) kappa(Ahat)^2 tol ~ 1e2 * 10 * 1e-6
    assert abs(info["iters"] - int(info_j["iters"])) <= 2
    assert _rel(x, xj) <= 1e-3
    assert _resid_excess(a, b, x) < 1e-6


@pytest.mark.parametrize("kappa,excess_tol", [(1e2, 1e-6), (1e6, 1e-3)])
def test_cgls_preconditioned_is_kappa_independent(kappa, excess_tol):
    a, _ = latms.rand_matrix_with_cond(4, 4096, 48, kappa)
    b = np.random.default_rng(5).uniform(-1, 1, 4096).astype(np.float32)
    x, info = tm.lstsq_cgls(*_ops(a), _t(b), 48, gen=_gen(), tol=1e-6,
                            max_iters=100, **CPU)
    assert info["iters"] <= 80
    assert _resid_excess(a, b, x) < excess_tol


def test_cgls_unpreconditioned_is_much_worse():
    a, _ = latms.rand_matrix_with_cond(4, 4096, 48, 1e4)
    b = _t(np.random.default_rng(5).uniform(-1, 1, 4096))
    x_un, info_un = tm.lstsq_cgls(*_ops(a), b, 48, tol=1e-6, max_iters=100,
                                  **CPU)
    x_pre, _ = tm.lstsq_cgls(*_ops(a), b, 48, gen=_gen(), tol=1e-6,
                             max_iters=100, **CPU)
    assert float(info_un["grad_rel"].max()) > 1e-6
    ex_un, ex_pre = _resid_excess(a, b, x_un), _resid_excess(a, b, x_pre)
    assert ex_un > 100 * max(ex_pre, 1e-12), (ex_un, ex_pre)


def test_cgls_exact_preconditioner_and_shapes():
    a, _ = latms.rand_matrix_with_cond(6, 2048, 32, 1e4)
    b = np.random.default_rng(7).uniform(-1, 1, (2048, 2)).astype(np.float32)
    r_true = torch.linalg.qr(_t(a), mode="r").R
    x, info = tm.lstsq_cgls(*_ops(a), _t(b), 32, r_precond=r_true, tol=1e-5,
                            **CPU)
    assert info["iters"] <= 30 and _resid_excess(a, b, x) < 1e-6
    assert tuple(x.shape) == (32, 2)
    a1 = _rand(1024, 16, 8)
    b1 = np.random.default_rng(9).uniform(-1, 1, 1024).astype(np.float32)
    x1, _ = tm.lstsq_cgls(*_ops(a1), _t(b1), 16, gen=_gen(1), **CPU)
    assert tuple(x1.shape) == (16,)
    x64 = np.linalg.lstsq(a1.astype(np.float64), b1.astype(np.float64),
                          rcond=None)[0]
    np.testing.assert_allclose(_np(x1), x64, rtol=0, atol=1e-4)


# ---- pivoted_qr / interpolative / cur --------------------------------------

def _rank_k(m, n, k, seed=0, decay=None):
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((n, k)))[0]
    s = np.ones(k) if decay is None else decay ** np.arange(k)
    return ((u * s) @ v.T).astype(np.float32)


def test_pivoted_qr_matches_jax_through_the_draw(jax_draws):
    a = _rand(512, 32, 0)
    key = jax.random.PRNGKey(0)
    jax_draws("qrcp", key)
    q, r, piv, db = tm.pivoted_qr(_t(a), _gen(), **CPU)
    qj, rj, pivj, dbj = jm.pivoted_qr(jnp.asarray(a), key)
    assert np.array_equal(piv.numpy(), np.asarray(pivj))
    assert _rel(db, dbj) <= _tol() and _rel(r, rj) <= _tol()
    assert _rel(q, qj) <= _tol()


def test_pivoted_qr_contracts():
    # full rank: a permutation, the factorization, a non-increasing
    # rank-revealing diagonal
    a = _rand(512, 32, 0)
    q, r, piv, db = tm.pivoted_qr(_t(a), _gen(), **CPU)
    assert sorted(piv.tolist()) == list(range(32))
    ap = a.astype(np.float64)[:, piv.numpy()]
    assert _rel(_np(q) @ _np(r), ap) < 1e-6
    assert np.all(np.diff(_np(db)) <= 1e-5 * float(db[0]))
    # exact rank 8: revealed, and the truncation reconstructs A, across
    # the sketch's chunk boundary (m > 2^16 rows)
    rng = np.random.default_rng(1)
    for m, rk in ((512, 8), ((1 << 16) + 4000, 5)):
        a = (rng.standard_normal((m, rk)) @ rng.standard_normal((rk, 16))
             ).astype(np.float32)
        q, r, piv, db = tm.pivoted_qr(_t(a), _gen(1), **CPU)
        assert int((db > 1e-5 * db[0]).sum()) == rk
        ap = a.astype(np.float64)[:, piv.numpy()]
        assert _rel(_np(q)[:, :rk] @ _np(r)[:rk], ap) < 1e-5
    # a decaying spectrum: the sketch diagonal tracks it
    u, _ = np.linalg.qr(rng.standard_normal((1024, 24)))
    v, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    s = 2.0 ** -np.arange(24)
    _, _, _, db = tm.pivoted_qr(_t((u * s) @ v.T), _gen(2), **CPU)
    ratio = _np(db)[:20] / s[:20]
    assert ratio.max() / ratio.min() < 64.0
    with pytest.raises(ValueError):
        tm.pivoted_qr(torch.ones(8, 16), _gen(), **CPU)


def test_pivoted_qr_grad_matches_jax(jax_draws):
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (256, 16)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (16, 16)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jax_draws("qrcp", key)
    at = _t(a).requires_grad_()
    _, r, _, _ = tm.pivoted_qr(at, _gen(), **CPU)
    (g,) = torch.autograd.grad((_t(w) * r ** 2).sum(), at)
    g_j = jax.grad(lambda x: jnp.vdot(
        w, jm.pivoted_qr(x, key)[1] ** 2))(jnp.asarray(a))
    assert bool(torch.isfinite(g).all()) and _rel(g, g_j) <= _tol()


def test_interpolative_matches_jax_through_the_draw(jax_draws):
    a = _rank_k(1024, 64, 6, seed=9)
    key = jax.random.PRNGKey(0)
    jax_draws("qrcp", key)
    cols, coeff, db = tm.interpolative(_t(a), _gen(), 6, **CPU)
    cols_j, coeff_j, db_j = jm.interpolative(jnp.asarray(a), key, 6)
    assert np.array_equal(cols.numpy(), np.asarray(cols_j))
    a64 = a.astype(np.float64)
    rec = a64[:, cols.numpy()] @ _np(coeff)
    rec_j = a64[:, np.asarray(cols_j)] @ _np(coeff_j)
    assert _rel(rec, rec_j) <= _tol() and _rel(db[:6], db_j[:6]) <= _tol()


def test_interpolative_contracts():
    a = _rank_k(1024, 64, 6, seed=9)
    cols, coeff, db = tm.interpolative(_t(a), _gen(), 6, **CPU)
    a64 = a.astype(np.float64)
    assert _rel(a64[:, cols.numpy()] @ _np(coeff), a64) < 1e-4
    np.testing.assert_allclose(_np(coeff)[:, cols.numpy()], np.eye(6),
                               rtol=0, atol=1e-5)
    assert float(db[6]) < 1e-4 * float(db[0])
    a = _rank_k(2048, 96, 40, seed=10, decay=0.5)
    cols, coeff, _ = tm.interpolative(_t(a), _gen(1), 10, **CPU)
    a64 = a.astype(np.float64)
    assert _rel(a64[:, cols.numpy()] @ _np(coeff), a64) < 3e-2
    assert len(set(cols.tolist())) == 10


def test_cur_matches_jax_through_the_draw(jax_draws):
    a = _rank_k(768, 48, 5, seed=11)
    key = jax.random.PRNGKey(2)
    jax_draws("qrcp", key)
    cols, u, rows = tm.cur(_t(a), _gen(), 5, **CPU)
    cols_j, u_j, rows_j = jm.cur(jnp.asarray(a), key, 5)
    assert np.array_equal(cols.numpy(), np.asarray(cols_j))
    assert np.array_equal(rows.numpy(), np.asarray(rows_j))
    a64 = a.astype(np.float64)
    rec = a64[:, cols.numpy()] @ _np(u) @ a64[rows.numpy()]
    rec_j = a64[:, np.asarray(cols_j)] @ _np(u_j) @ a64[np.asarray(rows_j)]
    assert _rel(rec, rec_j) <= _tol() and _rel(rec, a64) < 1e-4


def test_cur_contracts_and_skeleton_errors():
    a = _rank_k(1024, 80, 40, seed=12, decay=0.6)
    cols, u, rows = tm.cur(_t(a), _gen(3), 12, **CPU)
    a64 = a.astype(np.float64)
    rec = a64[:, cols.numpy()] @ _np(u) @ a64[rows.numpy()]
    assert _rel(rec, a64) < 5e-2
    ones = torch.ones(64, 32)
    with pytest.raises(ValueError, match="interpolative"):
        tm.interpolative(ones, _gen(), 0, **CPU)
    with pytest.raises(ValueError, match="interpolative"):
        tm.interpolative(ones, _gen(), 33, **CPU)
    with pytest.raises(ValueError, match="cur"):
        tm.cur(ones, _gen(), 40, **CPU)


# ---- subspace_iteration / nystrom ------------------------------------------

def test_subspace_iteration_matches_jax_through_the_draw(jax_draws):
    n, k = 512, 6
    spectrum = np.concatenate([[10., 8., 6., 5., 4., 3.],
                               np.linspace(1.0, 0.01, n - 6)])
    a64 = _sym(n, spectrum, 0)
    at, aj = _t(a64), jnp.asarray(a64, jnp.float32)
    key = jax.random.PRNGKey(0)
    jax_draws("subspace", key)
    w, v, res = tm.subspace_iteration(lambda x: at @ x, n, k, _gen(),
                                      iters=30, return_resid=True, **CPU)
    wj, vj = jm.subspace_iteration(lambda x: aj @ x, n, k, key, iters=30)
    assert _rel(w, wj) <= _tol() and _proj_dist(v, vj) < 1e-3
    w_ref = np.linalg.eigvalsh(a64)[::-1][:k]
    np.testing.assert_allclose(_np(w), w_ref, rtol=1e-4)
    assert _orth(v) < 1e-5 and np.all(_np(res) < 1e-2 * np.abs(w_ref))
    v_ref = np.linalg.eigh(a64)[1][:, ::-1][:, :k]
    assert _proj_dist(v, v_ref) < 1e-3


def test_subspace_iteration_signed_spectrum():
    n = 256
    a64 = _sym(n, np.concatenate([[-9., 7., -5.],
                                  np.linspace(1.0, 0.01, n - 3)]), 1)
    at = _t(a64)
    w, _ = tm.subspace_iteration(lambda x: at @ x, n, 3, _gen(1), iters=40,
                                 **CPU)
    np.testing.assert_allclose(_np(w), [-9., 7., -5.], rtol=1e-3)


def test_nystrom_matches_jax_through_the_draw(jax_draws):
    n, rank = 512, 10
    spectrum = np.concatenate([np.logspace(0, -2, rank),
                               1e-6 * np.linspace(1.0, 0.1, n - rank)])
    a64 = _sym(n, spectrum, 2)
    at, aj = _t(a64), jnp.asarray(a64, jnp.float32)
    key = jax.random.PRNGKey(2)
    jax_draws("subspace", key)
    u, lam = tm.nystrom(lambda x: at @ x, n, rank, _gen(), **CPU)
    uj, lamj = jm.nystrom(lambda x: aj @ x, n, rank, key)
    assert _rel(lam, lamj) <= _tol() and _proj_dist(u, uj) < 1e-3
    assert _orth(u) < 1e-5 and bool((lam >= 0).all())
    np.testing.assert_allclose(_np(lam), spectrum[:rank], rtol=1e-2)
    err = np.linalg.norm(a64 - (_np(u) * _np(lam)) @ _np(u).T, 2)
    assert err < max(10 * spectrum[rank], 2e-4)


def test_nystrom_exact_rank_and_matrix_free():
    n = 512
    v8 = np.linalg.qr(np.random.default_rng(7).standard_normal((n, 6)))[0]
    lam6 = np.array([5., 4., 3., 2., 1., 0.5])
    a6 = _t((v8 * lam6) @ v8.T)
    u6, l6 = tm.nystrom(lambda x: a6 @ x, n, 6, _gen(7), **CPU)
    np.testing.assert_allclose(_np(l6), lam6, rtol=1e-4)
    assert np.linalg.norm(_np(a6) - (_np(u6) * _np(l6)) @ _np(u6).T, 2) < 1e-4
    # an operator known only through its apply: a small diagonal plus
    # low-rank spikes
    n = 2048
    z = _t(np.linalg.qr(np.random.default_rng(3).standard_normal((n, 4)))[0])
    spikes = torch.tensor([8.0, 6.0, 4.0, 2.0])

    def mv(x):
        return 1e-5 * x + z @ (spikes[:, None] * (z.T @ x))

    u, lam = tm.nystrom(mv, n, 4, _gen(3), **CPU)
    # the 1e-5 background sits at the float32 floor of the spikes' sketch,
    # so the estimate moves ~1e-3 from draw to draw in both packages (JAX
    # keys 0-5: 0.7e-3 to 1.9e-3): the JAX test's 1e-3 holds for its key
    # (test_nystrom_matrix_free_through_the_draw), 1e-2 for any draw
    np.testing.assert_allclose(_np(lam), _np(spikes) + 1e-5, rtol=1e-2)
    assert _proj_dist(u, z) < 1e-2


def test_nystrom_matrix_free_through_the_draw(jax_draws):
    n = 2048
    z = np.linalg.qr(np.random.default_rng(3).standard_normal((n, 4)))[0]
    zt, zj = _t(z), jnp.asarray(z, jnp.float32)
    spikes = np.array([8.0, 6.0, 4.0, 2.0], np.float32)
    key = jax.random.PRNGKey(3)
    jax_draws("subspace", key)
    u, lam = tm.nystrom(
        lambda x: 1e-5 * x + zt @ (_t(spikes)[:, None] * (zt.T @ x)), n, 4,
        _gen(), **CPU)
    _, lam_j = jm.nystrom(
        lambda x: 1e-5 * x + zj @ (spikes[:, None] * (zj.T @ x)), n, 4, key)
    assert _rel(lam, lam_j) <= _tol()
    np.testing.assert_allclose(_np(lam), spikes + 1e-5, rtol=1e-3)
    assert _proj_dist(u, z) < 1e-2
