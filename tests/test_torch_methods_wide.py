"""Past n = 128, on the CPU: the fused CholeskyQR methods in the wide
kernels' range (their plain version here) against the JAX package's
fused methods in interpret mode, and tsqr and the models built on it
against the JAX package, on the same numpy inputs."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
import tsqr_tpu.models as jm
import tsqr_tpu_torch
import tsqr_tpu_torch.models as tm
from tsqr_tpu.core import cholqr as jcholqr
from tsqr_tpu.core import tsqr as jtsqr
from tsqr_tpu.ops import householder as jhouseholder
from tsqr_tpu_torch.core import auto, cholqr
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.ops import householder
from tsqr_tpu_torch.utils import latms, validation


MODE = "bf16x6_cor"
TOL = auto._TOL[auto.M(MODE)]
# (method, variant, options): every variant, inplace and the ladder hooks
CASES = [
    ("cholqr1_fused", None, {}),
    ("cholqr1_fused", None, {"return_qgram": True}),
    ("cholqr1_fused", None, {"inplace": True}),
    ("cholqr2_fused", "safe", {}),
    ("cholqr2_fused", "fast", {}),
    ("cholqr2_fused", "fastest", {}),
    ("cholqr2_fused", "compact", {}),
    ("cholqr2_fused", "turbo", {"inplace": True}),
    ("cholqr3_fused", "safe", {}),
    ("cholqr3_fused", "fastest", {}),
    ("cholqr3_fused", "compact", {"inplace": True}),
    ("cholqr3_fused", "compact", {"g1": True, "return_qgram": True}),
    ("cholqr_iter_fused", None, {"g1": True, "return_qgram": True}),
]


def _rel(x, ref) -> float:
    x = x.detach().double().numpy() if isinstance(x, torch.Tensor) else x
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@functools.lru_cache(maxsize=None)
def _matrix(m, n, kappa, seed=0):
    """One input per argument set, made once: read-only, so a case copies
    it before any in-place call."""
    a = latms.rand_matrix_with_cond(seed + m + n, m, n, kappa)[0]
    a.setflags(write=False)
    return a


def _run(pkg, a, method, variant, opts, mode=MODE):
    """One fused call in either package; ``g1`` is the Gram of ``a``."""
    interp = {} if pkg is cholqr else {"interpret": True}
    kw = dict(opts)
    if kw.pop("g1", False):
        a64 = np.asarray(a, np.float64)
        g = (a64.T @ a64).astype(np.float32)
        kw["g1"] = torch.from_numpy(g) if pkg is cholqr else jnp.asarray(g)
    if variant is not None:
        kw["variant"] = variant
    return getattr(pkg, method)(a, mode, **interp, **kw)


@pytest.mark.parametrize("n", [200, 512])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_wide_fused_methods_match_jax(case, n):
    method, variant, opts = CASES[case]
    # single-pass CholeskyQR's Q is good to ~kappa^2 eps: a uniform input;
    # fastest and turbo relax Gram #1 to bf16: their contract is kappa
    # <~ 10, the others' kappa <~ 500
    if method == "cholqr1_fused":
        a = np.random.default_rng(n).uniform(-1, 1, (2048, n)).astype(
            np.float32)
    else:
        a = _matrix(2048, n, 8 if variant in ("fastest", "turbo") else 100)
    at = torch.from_numpy(a.copy())
    got = _run(cholqr, at, method, variant, opts)
    ref = _run(jcholqr, jnp.asarray(a), method, variant, opts)
    q, r = got[0], got[1]
    assert _rel(q, ref[0]) <= TOL and _rel(r, ref[1]) <= TOL
    if opts.get("inplace"):
        assert q.data_ptr() == at.data_ptr()
    if opts.get("return_qgram"):
        assert _rel(got[2], ref[2]) <= TOL
    assert validation.orthogonality(q) < TOL
    assert validation.residual(a, q, r) < TOL


# the fp32 pipelines past n = 1024, in fp32's range (2048): their
# bf16x3_cor corrections and relaxed middle passes stream there too
FP32_CASES = [
    ("cholqr3_fused", "safe", {}),
    ("cholqr3_fused", "compact", {}),
    ("cholqr2_fused", "fast", {}),
    ("cholqr2_fused", "turbo", {}),
    ("cholqr_iter_fused", None, {}),
]


@pytest.mark.parametrize("case", range(len(FP32_CASES)))
def test_fp32_fused_methods_past_1024_match_jax(case):
    method, variant, opts = FP32_CASES[case]
    tol = auto._TOL[auto.M("fp32")]
    a = _matrix(2048, 1100, 8 if variant == "turbo" else 100)
    got = _run(cholqr, torch.from_numpy(a.copy()), method, variant, opts,
               "fp32")
    ref = _run(jcholqr, jnp.asarray(a), method, variant, opts, "fp32")
    q, r = got[0], got[1]
    assert _rel(q, ref[0]) <= tol and _rel(r, ref[1]) <= tol
    assert validation.orthogonality(q) < tol
    assert validation.residual(a, q, r) < tol


def test_fastqr_inplace_entry_at_wide_n():
    a = _matrix(2048, 512, 100)
    at = torch.from_numpy(a.copy())
    q, r = tsqr_tpu_torch.fastqr_inplace(at, MODE, "cholqr3_fused",
                                         device="cpu")
    qj, rj = jcholqr.cholqr3_fused(jnp.asarray(a), MODE, interpret=True,
                                   variant="compact")
    assert q.data_ptr() == at.data_ptr()
    assert _rel(q, qj) <= TOL and _rel(r, rj) <= TOL


@pytest.mark.parametrize("impl", [None, "pallas", "pallas_sb"])
def test_tsqr_past_the_panel_kernel_matches_jax(impl):
    # 128 < n <= 512: every panel impl, and the default, on the wide panel
    # kernel (its plain version here), held to JAX's Householder tree
    a = np.random.default_rng(4).uniform(-1, 1, (2048, 256)).astype(
        np.float32)
    q, r = tsqr_mod.tsqr(torch.from_numpy(a), MODE, impl=impl, device="cpu")
    # the same leaves; the inner nodes reduce at fan-in 4 here (the panel
    # kernel's node at n = 256) and at 8 there, and R's row signs follow
    # the tree's shape: both factors in canonical signs
    qj, rj = jtsqr.tsqr(jnp.asarray(a), MODE,
                        leaf_rows=tsqr_mod.default_leaf_rows(256, impl))
    assert tsqr_mod.leaf_impl(impl, 256) == (impl or "pallas_sb")
    (qc, rc), (qjc, rjc) = (householder.qr_sign_normalize(q, r),
                            jhouseholder.qr_sign_normalize(qj, rj))
    assert _rel(rc, rjc) <= TOL and _rel(qc, qjc) <= TOL
    assert validation.orthogonality(q) < TOL
    if impl is not None:  # past n = 512, the blocked Householder, as JAX's
        wide = np.random.default_rng(5).uniform(-1, 1, (1200, 520)).astype(
            np.float32)
        q, r = tsqr_mod.tsqr(torch.from_numpy(wide), "fp32", impl=impl,
                             device="cpu")
        qj, rj = jtsqr.tsqr(jnp.asarray(wide), "fp32", impl="jnp")
        assert tsqr_mod.leaf_impl(impl, 520) == "jnp"
        assert _rel(r, rj) <= 1e-5 and _rel(q, qj) <= 1e-5


def test_rsvd_rank_200_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    m, n, k = 2048, 320, 200
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((n, k)))[0]
    a = ((u * np.linspace(10, 1, k)) @ v.T).astype(np.float32)
    key = jax.random.PRNGKey(0)
    # both packages orthogonalize the same draw (the models' seam)
    rsvd_mod = importlib.import_module("tsqr_tpu_torch.models.rsvd")
    monkeypatch.setattr(rsvd_mod, "_normal", lambda gen, shape, device: (
        torch.from_numpy(np.array(jax.random.normal(key, shape,
                                                    jnp.float32)))))
    us, s, vt = tm.rsvd(torch.from_numpy(a), k, torch.Generator(),
                        device="cpu")
    uj, sj, vtj = jm.rsvd(jnp.asarray(a), rank=k, key=key)
    assert _rel(s, sj) <= 1e-5
    rec = (us.double() * s.double()).numpy() @ vt.double().numpy()
    rec_j = (np.asarray(uj, np.float64) * np.asarray(sj)) @ np.asarray(
        vtj, np.float64)
    assert _rel(rec, rec_j) <= 1e-5


@pytest.mark.parametrize("method", ["tsqr", "cholqr2"])
def test_cca_256_wide_matches_jax(method):
    rng = np.random.default_rng(9)
    m, p, q = 4096, 256, 12
    z = rng.standard_normal((m, 2))
    x = np.c_[z + 0.1 * rng.standard_normal((m, 2)),
              rng.standard_normal((m, p - 2))]
    y = np.c_[z + 0.1 * rng.standard_normal((m, 2)),
              rng.standard_normal((m, q - 2))]
    c, _, _ = tm.cca(torch.from_numpy(x.astype(np.float32)),
                     torch.from_numpy(y.astype(np.float32)), method=method,
                     device="cpu")
    cj, _, _ = jm.cca(jnp.asarray(x, jnp.float32),
                      jnp.asarray(y, jnp.float32), method=method)
    assert _rel(c, cj) <= 1e-5
    ref = np.linalg.svd(np.linalg.qr(x)[0].T @ np.linalg.qr(y)[0],
                        compute_uv=False)
    np.testing.assert_allclose(c.double().numpy(), np.clip(ref, 0, 1),
                               atol=5e-5)
