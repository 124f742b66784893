"""QR updating of the port (core/update.py) against the JAX package's on
the same numpy inputs, all on the CPU.

Each update of A = Q R starts from the JAX package's factors, so both
packages update the same (Q, R); their Q' and R' agree within the
mode's tolerance (core/auto.py ``_TOL``) and factor the modified matrix
to the grade of a fresh QR.  The JAX tests' contracts
(tests/test_update.py) are the cases of ``test_update_contract``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu.core import blockqr as jblockqr
from tsqr_tpu.core import update as jupdate
from tsqr_tpu_torch.core import auto, update
from tsqr_tpu_torch.utils import validation


M, N = 512, 48


def _rand(m, n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (m, n)).astype(
        np.float32)


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _tol(mode) -> float:
    return auto._TOL[auto.M(mode)]


def _jax_factors(a, mode="fp32"):
    q, r = jblockqr.qr(jnp.asarray(a), mode)
    return np.asarray(q), np.asarray(r)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _assert_factorization(a, q, r, tol=1e-5):
    assert validation.orthogonality(q) < tol
    assert validation.residual(a, q, r) < tol
    rn = np.asarray(r.numpy() if isinstance(r, torch.Tensor) else r)
    assert np.array_equal(np.triu(rn), rn)


def _case(name, a):
    """(modified A, port call, JAX call) of one update of a's factors."""
    b_rows, b_cols = _rand(96, N, 1), _rand(M, 24, 2)
    u, v = _rand(M, 4, 3), _rand(N, 4, 4)
    keep = [j for j in range(N) if j not in (3, 0, 30)]
    return {
        "append_rows": (np.concatenate([a, b_rows]),
                        lambda q, r, md: update.qr_append_rows(
                            *_t(q, r, b_rows), md, device="cpu"),
                        lambda q, r, md: jupdate.qr_append_rows(
                            q, r, jnp.asarray(b_rows), md)),
        "append_cols": (np.concatenate([a, b_cols], axis=1),
                        lambda q, r, md: update.qr_append_cols(
                            *_t(q, r, b_cols), md, device="cpu"),
                        lambda q, r, md: jupdate.qr_append_cols(
                            q, r, jnp.asarray(b_cols), md)),
        "delete_cols": (a[:, keep],
                        lambda q, r, md: update.qr_delete_cols(
                            *_t(q, r), (3, 0, 30), md, device="cpu"),
                        lambda q, r, md: jupdate.qr_delete_cols(
                            q, r, (3, 0, 30), md)),
        "delete_rows": (a[128:],
                        lambda q, r, md: update.qr_delete_rows(
                            *_t(q, r), 128, md, device="cpu"),
                        lambda q, r, md: jupdate.qr_delete_rows(
                            q, r, 128, md)),
        "rank_update": (a + u @ v.T,
                        lambda q, r, md: update.qr_rank_update(
                            *_t(q, r, u, v), md, device="cpu"),
                        lambda q, r, md: jupdate.qr_rank_update(
                            q, r, jnp.asarray(u), jnp.asarray(v), md)),
    }[name]


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
@pytest.mark.parametrize("name", ["append_rows", "append_cols",
                                  "delete_cols", "delete_rows",
                                  "rank_update"])
def test_update_matches_jax(name, mode):
    a = _rand(M, N)
    q, r = _jax_factors(a, mode)
    a2, port, ref = _case(name, a)
    q2, r2 = port(q, r, mode)
    qj, rj = ref(jnp.asarray(q), jnp.asarray(r), mode)
    assert q2.dtype == torch.float32 and tuple(q2.shape) == qj.shape
    assert _rel(q2, qj) <= _tol(mode) and _rel(r2, rj) <= _tol(mode)
    _assert_factorization(a2, q2, r2)


def _streaming_chain():
    blocks = [_rand(256, 32, seed=s) for s in range(3)]
    q, r = _jax_factors(blocks[0])
    qp, rp = _t(q, r)
    qj, rj = jnp.asarray(q), jnp.asarray(r)
    for b in blocks[1:]:
        qp, rp = update.qr_append_rows(qp, rp, torch.from_numpy(b),
                                       device="cpu")
        qj, rj = jupdate.qr_append_rows(qj, rj, jnp.asarray(b))
    assert _rel(qp, qj) <= 1e-5 and _rel(rp, rj) <= 1e-5
    _assert_factorization(np.concatenate(blocks), qp, rp)


def _cgs2_correlated():
    # new columns nearly parallel to existing ones: CGS2 keeps Q'
    # orthogonal where the single pass drifts
    a = _rand(2048, 32)
    b = a[:, :16] + 1e-4 * _rand(2048, 16, seed=3)
    q, r = _jax_factors(a)
    q1, _ = update.qr_append_cols(*_t(q, r, b), device="cpu")
    q2, r2 = update.qr_append_cols(*_t(q, r, b), reorth=True, device="cpu")
    qj, rj = jupdate.qr_append_cols(jnp.asarray(q), jnp.asarray(r),
                                    jnp.asarray(b), reorth=True)
    o1, o2 = validation.orthogonality(q1), validation.orthogonality(q2)
    assert o2 < 1e-5 and o2 <= o1
    # R's old rows (R, R12 = Q^T B) agree to float32 grade; the new
    # block's R22 (entries ~1e-4) only to its conditioning, kappa ~ 1e4,
    # so it is held to the factorization's residual instead
    assert _rel(r2[:32], np.asarray(rj)[:32]) <= 1e-5
    assert validation.residual(np.concatenate([a, b], axis=1), q2,
                               r2) < 1e-4


def _bad_idx():
    q, r = _t(*_jax_factors(_rand(64, 8)))
    for bad in (8, tuple(range(8)), -1):
        with pytest.raises(ValueError):
            update.qr_delete_cols(q, r, bad, device="cpu")
        with pytest.raises(ValueError):
            jupdate.qr_delete_cols(jnp.asarray(q.numpy()),
                                   jnp.asarray(r.numpy()), bad)


def _nan_on_lost_rank():
    # the dropped rows carry all of column 0's direction: the downdated
    # Gram is singular, and the contract is NaN, not a made-up basis
    a = _rand(256, 16, seed=6)
    a[4:, 0] = 0.0
    a[:4, 1:] = 0.0
    q, r = _jax_factors(a)
    q2, _ = update.qr_delete_rows(*_t(q, r), 4, device="cpu")
    qj, _ = jupdate.qr_delete_rows(jnp.asarray(q), jnp.asarray(r), 4)
    assert not torch.isfinite(q2).all()
    assert not np.isfinite(np.asarray(qj)).all()


def _roundtrip_downdate():
    a = _rand(384, 32, seed=10)
    u, v = _rand(384, 2, seed=11), _rand(32, 2, seed=12)
    q, r = _jax_factors(a)
    q1, r1 = update.qr_rank_update(*_t(q, r, u, v), device="cpu")
    q2, r2 = update.qr_rank_update(q1, r1, *_t(-u, v), device="cpu")
    _assert_factorization(a, q2, r2)
    qj, rj = jupdate.qr_rank_update(jnp.asarray(q), jnp.asarray(r),
                                    jnp.asarray(u), jnp.asarray(v))
    qj, rj = jupdate.qr_rank_update(qj, rj, jnp.asarray(-u), jnp.asarray(v))
    assert _rel(q2, qj) <= 1e-5 and _rel(r2, rj) <= 1e-5


def _wide_contracts():
    q, r = _t(*_jax_factors(_rand(64, 60)))
    with pytest.raises(ValueError, match="wide"):
        update.qr_append_cols(q, r, torch.from_numpy(_rand(64, 8, 17)),
                              device="cpu")
    with pytest.raises(ValueError, match="wide"):
        update.qr_delete_rows(q, r, 8, device="cpu")
    with pytest.raises(ValueError, match="cols"):
        update.qr_append_rows(q, r, torch.zeros(4, 59), device="cpu")
    with pytest.raises(ValueError, match="border"):
        update.qr_rank_update(q, r, torch.zeros(64, 2), torch.zeros(59, 2),
                              device="cpu")


CONTRACTS = {"streaming_chain": _streaming_chain,
             "cgs2_correlated": _cgs2_correlated,
             "bad_idx": _bad_idx,
             "nan_on_lost_rank": _nan_on_lost_rank,
             "roundtrip_downdate": _roundtrip_downdate,
             "wide_contracts": _wide_contracts}


@pytest.mark.parametrize("case", list(CONTRACTS))
def test_update_contract(case):
    CONTRACTS[case]()


@pytest.mark.parametrize("polish", [False, True])
def test_delete_rows_polish_matches_jax(polish):
    a = _rand(M, N, seed=5)
    q, r = _jax_factors(a)
    q2, r2 = update.qr_delete_rows(*_t(q, r), 128, polish=polish,
                                   device="cpu")
    qj, rj = jupdate.qr_delete_rows(jnp.asarray(q), jnp.asarray(r), 128,
                                    polish=polish)
    assert _rel(q2, qj) <= 1e-5 and _rel(r2, rj) <= 1e-5
    _assert_factorization(a[128:], q2, r2, 1e-5 if polish else 1e-4)


def test_append_rows_gradient_matches_jax():
    a, b = _rand(128, 8), _rand(16, 8, seed=14)
    q, r = _jax_factors(a)
    w, v = _rand(144, 8, seed=15), _rand(8, 8, seed=16)

    def loss_jax(b_):
        q2, r2 = jupdate.qr_append_rows(jnp.asarray(q), jnp.asarray(r), b_)
        return jnp.sum(q2 * w) + jnp.sum(r2 * v)

    gj = np.asarray(jax.grad(loss_jax)(jnp.asarray(b)))
    bt = torch.from_numpy(b).requires_grad_(True)
    q2, r2 = update.qr_append_rows(*_t(q, r), bt, device="cpu")
    (torch.sum(q2 * torch.from_numpy(w))
     + torch.sum(r2 * torch.from_numpy(v))).backward()
    assert np.isfinite(gj).all()
    assert _rel(bt.grad, gj) <= 1e-5


def test_updates_keep_the_io_dtype_and_the_card_default():
    a = _rand(256, 16)
    q, r = _t(*_jax_factors(a))
    q2, r2 = update.qr_append_rows(q, r, torch.from_numpy(_rand(32, 16, 1)),
                                   "bf16", device="cpu")
    assert q2.dtype == r2.dtype == torch.bfloat16
    assert torch.equal(torch.triu(r2), r2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            update.qr_delete_cols(q, r, 0)
