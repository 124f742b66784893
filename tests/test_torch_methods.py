"""The CholeskyQR methods beyond the ladder's: cholqr2_fused, the
non-fused methods, the packed shims, in-place Q and rand_cholqr, against
the JAX package on the same numpy inputs (its fused methods in interpret
mode)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
import tsqr_tpu_torch
from tsqr_tpu.core import cholqr as jcholqr
from tsqr_tpu_torch.core import cholqr
from tsqr_tpu_torch.utils import latms, validation


@functools.lru_cache(maxsize=None)
def _made(m, n, kappa, seed):
    if kappa == 1:
        a = np.random.default_rng(seed + m + n).uniform(
            -1, 1, (m, n)).astype(np.float32)
    else:
        a = latms.rand_matrix_with_cond(seed + m + n, m, n, kappa)[0]
    a.setflags(write=False)
    return a


def _matrix(m, n, kappa, seed=0):
    """One input per argument set, made once; each case gets its own
    copy, since most hand it straight to ``torch.from_numpy``."""
    return _made(m, n, kappa, seed).copy()


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("variant",
                         ["safe", "fast", "fastest", "compact", "turbo"])
def test_cholqr2_fused_matches_jax(variant):
    # fastest and turbo relax Gram #1 to bf16: their contract is kappa
    # <~ 10, the others' kappa <~ 500
    a = _matrix(1024, 64, 8 if variant in ("fastest", "turbo") else 100)
    q, r = cholqr.cholqr2_fused(torch.from_numpy(a), "bf16x6_cor",
                                variant=variant)
    qj, rj = jcholqr.cholqr2_fused(jnp.asarray(a), "bf16x6_cor",
                                   interpret=True, variant=variant)
    # the same pipeline in both packages at float32 grade; the Grams sum
    # in other orders, and R and Q differ by 1-3e-7 (measured)
    assert _rel(r, rj) <= 2e-6 and _rel(q, qj) <= 2e-6
    orth = validation.orthogonality(q)
    assert orth < 1e-6 and orth < 3 * validation.orthogonality(qj)
    assert validation.residual(a, q, r) < 1e-6


def test_cholqr2_fused_cheap_mode_matches_jax():
    a = np.array(jnp.asarray(_matrix(1024, 64, 1)).astype(jnp.bfloat16)
                 .astype(jnp.float32))
    q, r = cholqr.cholqr2_fused(torch.from_numpy(a).bfloat16(), "bf16",
                                variant="turbo")
    qj, rj = jcholqr.cholqr2_fused(jnp.asarray(a).astype(jnp.bfloat16),
                                   "bf16", interpret=True, variant="turbo")
    assert q.dtype == r.dtype == torch.bfloat16
    # two chained bf16 products rounded on their own in either package
    assert _rel(r.float(), np.asarray(rj, np.float32)) <= 1e-2
    assert validation.orthogonality(q) < 5e-2


@pytest.mark.parametrize("m,n", [(1001, 16), (2048, 200)])
@pytest.mark.parametrize("method",
                         ["cholqr1", "cholqr2", "cholqr3", "cholqr_iter"])
def test_nonfused_methods_match_jax_to_grade(method, m, n):
    a = _matrix(m, n, 10)
    q, r = tsqr_tpu_torch.fastqr(torch.from_numpy(a), "bf16x6_cor", method,
                                 device="cpu")
    qj, rj = jcholqr.fastqr(jnp.asarray(a), "bf16x6_cor", method=method)
    orth, orth_j = validation.orthogonality(q), validation.orthogonality(qj)
    # both are float32-grade Gram methods with uncompensated Grams whose
    # products sum in other orders: R differs by 0.7-3.6e-7 (measured)
    # and the orthogonality lands on the same grade (cholqr1's ~kappa^2
    # eps within 2x of JAX's)
    assert orth < max(3 * orth_j, 1e-6)
    assert validation.residual(a, q, r) < 1e-6
    assert _rel(r, rj) <= 2e-6
    assert np.array_equal(np.triu(r.numpy()), r.numpy())


@pytest.mark.parametrize("method", ["cholqr1", "cholqr2", "cholqr3"])
def test_qr_packed_matches_jax(method):
    # m = 1001 is not a multiple of p = 128 // 16 = 8: one ragged packed
    # row whose pad rows must stay zero
    m, n = 1001, 16
    a = _matrix(m, n, 1)
    ap = tsqr_tpu_torch.pack_panel(torch.from_numpy(a))
    apj = jcholqr.pack_panel(jnp.asarray(a))
    assert torch.equal(ap, torch.from_numpy(np.array(apj)))
    qp, r = tsqr_tpu_torch.qr_packed(ap, n, "fp32", method=method)
    qpj, rj = jcholqr.qr_packed(apj, n, "fp32", method=method)
    assert tuple(qp.shape) == tuple(qpj.shape) == (126, 128)
    assert bool((qp.reshape(-1, n)[m:] == 0).all())
    q = tsqr_tpu_torch.unpack_panel(qp, m, n)
    qj = jcholqr.unpack_panel(qpj, m, n)
    # the same algorithm on the unpacked rows: 1e-7 apart (measured)
    assert _rel(r, rj) <= 1e-6 and _rel(q, qj) <= 1e-6
    assert validation.residual(a, q, r) < 1e-6
    with pytest.raises(ValueError, match="multiple"):
        tsqr_tpu_torch.qr_packed(torch.zeros(64, 120), 16)
    with pytest.raises(ValueError, match="n <= 64"):
        tsqr_tpu_torch.pack_panel(torch.zeros(256, 80))


INPLACE = [("cholqr1_fused", "safe", "bf16"),
           ("cholqr2_fused", "compact", "bf16x6_cor"),
           ("cholqr2_fused", "turbo", "bf16x6_cor"),
           ("cholqr3_fused", "compact", "fp32")]


@pytest.mark.parametrize("method,variant,mode", INPLACE)
def test_inplace_is_bitwise_and_shares_storage(method, variant, mode):
    io = torch.bfloat16 if mode == "bf16" else torch.float32
    a0 = torch.from_numpy(_matrix(768, 64, 1)).to(io)
    kw = {} if method == "cholqr1_fused" else {"variant": variant}
    q0, r0 = cholqr._METHODS[method](a0, mode, **kw)
    a = a0.clone()
    q, r = tsqr_tpu_torch.fastqr_inplace(a, mode, method, variant,
                                         device="cpu")
    assert q.data_ptr() == a.data_ptr()
    assert torch.equal(q, q0) and torch.equal(r, r0) and torch.equal(a, q0)
    assert validation.orthogonality(q) < (5e-2 if mode == "bf16" else 5e-6)


def test_inplace_raises_as_jax_does():
    a = torch.from_numpy(_matrix(512, 64, 1))
    with pytest.raises(ValueError, match="io_dtype == a.dtype"):
        cholqr.cholqr1_fused(a, "bf16", inplace=True)
    with pytest.raises(ValueError, match="recompute pipeline"):
        cholqr.cholqr2_fused(a, "bf16x6_cor", variant="fastest", inplace=True)
    with pytest.raises(ValueError, match="recompute pipeline"):
        cholqr.cholqr3_fused(a, "fp32", variant="safe", inplace=True)
    # past the JAX package's kernel range at each mode (1024, 2048)
    with pytest.raises(ValueError, match="fused-kernel range"):
        cholqr.cholqr2_fused(torch.zeros(1040, 1032), "bf16x6_cor",
                             variant="compact", inplace=True)
    with pytest.raises(ValueError, match="fused-kernel range"):
        cholqr.cholqr1_fused(torch.zeros(2064, 2056), "fp32", inplace=True)
    with pytest.raises(ValueError, match="unsupported method"):
        tsqr_tpu_torch.fastqr_inplace(a, "fp32", "cholqr2", device="cpu")
    # a copy would hold Q, not the caller's array
    with pytest.raises(ValueError, match="caller's tensor"):
        tsqr_tpu_torch.fastqr_inplace(a.numpy(), "fp32", device="cpu")


def test_fused_methods_delegate_past_the_kernel_range():
    # past the JAX package's kernel range at the mode (n = 1032 > 1024 at
    # bf16x3_cor; n = 2056 > 2048 at fp32) the fused methods run their
    # non-fused siblings, as the JAX package does; the capacity variants
    # and the ladder hooks raise instead
    for mode, (m, n) in (("bf16x3_cor", (1040, 1032)), ("fp32", (2064, 2056))):
        a = torch.from_numpy(_matrix(m, n, 10))
        for fused, plain in (("cholqr1_fused", "cholqr1"),
                             ("cholqr2_fused", "cholqr2"),
                             ("cholqr3_fused", "cholqr3"),
                             ("cholqr_iter_fused", "cholqr_iter")):
            q, r = cholqr.fastqr(a, mode, fused, device="cpu")
            q1, r1 = cholqr.fastqr(a, mode, plain, device="cpu")
            assert torch.equal(q, q1) and torch.equal(r, r1)
        for method, variant in (("cholqr2_fused", "turbo"),
                                ("cholqr3_fused", "compact")):
            with pytest.raises(ValueError, match="fused-kernel range"):
                cholqr.fastqr(a, mode, method, variant, device="cpu")
        with pytest.raises(ValueError, match="fused-kernel range"):
            cholqr.cholqr_iter_fused(a, mode, return_qgram=True)
    q, _ = cholqr.fastqr(a, "fp32", "cholqr2_fused", "fastest", device="cpu")
    assert validation.orthogonality(q) < 1e-5


def test_fastqr_takes_every_method_of_jax():
    assert set(cholqr._METHODS) == set(jcholqr._METHODS)
    a = torch.from_numpy(_matrix(512, 32, 1))
    with pytest.raises(ValueError, match="no variants"):
        cholqr.fastqr(a, "fp32", "cholqr2", "fastest", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        cholqr.fastqr(a, "fp32", "cholqr4", device="cpu")


@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e6])
def test_rand_cholqr_orthogonality_is_kappa_independent(kappa):
    a = _matrix(4096, 64, kappa)
    q, r = cholqr.rand_cholqr(torch.from_numpy(a), "fp32")
    assert validation.orthogonality(q) < 1e-5
    # the residual carries the kappa-amplified fl(A R_s^-1) floor, the
    # JAX package's own budget
    assert validation.residual(a, q, r) < max(1e-6 * kappa, 1e-5)
    assert bool((torch.diagonal(r) > 0).all())


def test_rand_cholqr_seed_and_jax_r():
    a = _matrix(2048, 48, 1e3)
    at = torch.from_numpy(a)
    q0, r0 = cholqr.rand_cholqr(at, "bf16x6_cor", seed=3)
    q1, r1 = cholqr.rand_cholqr(at, "bf16x6_cor", seed=3)
    assert torch.equal(q0, q1) and torch.equal(r0, r1)
    q2, r2 = cholqr.rand_cholqr(at, "bf16x6_cor", seed=4)
    assert not torch.equal(r0, r2)
    qf, rf = tsqr_tpu_torch.fastqr(at, "bf16x6_cor", "rand_cholqr",
                                   device="cpu")
    assert torch.equal(rf, cholqr.rand_cholqr(at, "bf16x6_cor", seed=0)[1])
    # other sketches, the same unique factorization (diag(R) > 0): R
    # agrees with JAX's and with another seed's to ~kappa eps (9.5e-7
    # for both, measured at kappa = 1e3)
    _, rj = jcholqr.rand_cholqr(jnp.asarray(a), "bf16x6_cor", seed=3)
    assert _rel(r0, rj) <= 1e-5 and _rel(r0, r2) <= 1e-5
    assert validation.orthogonality(q0) < 1e-5
    with pytest.raises(ValueError, match="m >="):
        cholqr.rand_cholqr(at[:64], "fp32")
