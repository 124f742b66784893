"""Out-of-core and matrix-free QR of the port (core/ooc.py) against the
JAX package's (tsqr_tpu/core/ooc.py), on the CPU, on the same numpy
inputs.

Both packages' Q and R agree within the mode's tolerance (core/auto.py
``_TOL``); the metrics agree to the accuracy each is read at.  The
matrix-free drivers get the same generator in both packages: chunk i of
one fixed numpy matrix (a ``lax.dynamic_slice`` on the JAX side).  The
checkpoint contract is held bitwise in the port alone, and a checkpoint
the JAX package wrote resumes in the port.  The JAX tests' bf16 host
arrays are ml_dtypes; here the port gets CPU ``torch.bfloat16`` tensors
of the same values, and the comparisons are in float32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu.core import ooc as jooc
from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import auto, ooc
from tsqr_tpu_torch.utils import latms, validation

# the packages re-export the lstsq function under its module's name
jlstsq = importlib.import_module("tsqr_tpu.models.lstsq")
plstsq = importlib.import_module("tsqr_tpu_torch.models.lstsq")


def _rand(m, n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (m, n)).astype(
        np.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rel(x, ref) -> float:
    x, ref = np.asarray(_f32(x), np.float64), np.asarray(_f32(ref), np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _tol(mode) -> float:
    return auto._TOL[auto.M(mode)]


def _host_a(a32, mode):
    """(the port's a, JAX's a) for a mode: bf16 as a torch tensor and an
    ml_dtypes array of the same values, else the float32 array."""
    if mode == "bf16":
        return torch.from_numpy(a32).to(torch.bfloat16), a32.astype(
            jnp.bfloat16)
    return a32, a32


@pytest.mark.parametrize("mode,method", [
    ("fp32", "cholqr1"), ("fp32", "cholqr2"), ("fp32", "cholqr3"),
    ("bf16x6_cor", "cholqr2"), ("bf16x6_cor", "cholqr3"),
    ("bf16", "cholqr1")])
def test_qr_out_of_core_matches_jax(mode, method):
    a32 = _rand(4096, 48, 2)
    a, aj = _host_a(a32, mode)
    q, r = ooc.qr_out_of_core(a, mode, method=method, chunk_rows=1024,
                              device="cpu")
    qj, rj = jooc.qr_out_of_core(aj, mode, method=method, chunk_rows=1024)
    tol = _tol(mode)
    assert q.dtype == (torch.bfloat16 if mode == "bf16" else torch.float32)
    assert r.dtype == torch.float32 and torch.equal(torch.triu(r), r)
    assert _rel(q, qj) <= tol and _rel(r, rj) <= tol
    grade = 2e-2 if mode == "bf16" else 1e-5
    assert validation.orthogonality(_f32(q)) < grade
    assert validation.residual(a32, _f32(q), _f32(r)) < grade


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
def test_chunk_gram_sums_blocks_in_float64(mode):
    # a chunk of two full blocks and a ragged tail: float32 products a
    # block, float64 across the blocks, float32 grade against float64
    a = _rand(2 * ooc.GRAM_BLOCK + 100, 16, 13)
    x = torch.from_numpy(a)
    g = ooc._gram(x, modes.resolve(mode))
    a64 = a.astype(np.float64)
    assert g.dtype == torch.float32
    assert _rel(g, a64.T @ a64) < 1e-6
    # a chunk that is one ragged block takes modes.gram itself
    g_small = ooc._gram(x[:1000], modes.resolve(mode))
    assert torch.equal(g_small, modes.gram(x[:1000],
                                                modes.resolve(mode)))
    # and the QR over such chunks matches the JAX package's
    q, r = ooc.qr_out_of_core(a, mode, method="cholqr2", chunk_rows=8192,
                              device="cpu")
    qj, rj = jooc.qr_out_of_core(a, mode, method="cholqr2", chunk_rows=8192)
    assert _rel(q, qj) <= _tol(mode) and _rel(r, rj) <= _tol(mode)


def test_out_aliases_a_like_jax():
    a = _rand(2048, 16, 1)
    a_copy, aj = a.copy(), a.copy()
    q, r = ooc.qr_out_of_core(a, "fp32", method="cholqr3", chunk_rows=512,
                              out=a, device="cpu")
    qj, rj = jooc.qr_out_of_core(aj, "fp32", method="cholqr3",
                                 chunk_rows=512, out=aj)
    assert q is a  # Q overwrote A
    assert _rel(q, qj) <= _tol("fp32") and _rel(r, rj) <= _tol("fp32")
    assert validation.residual(a_copy, q, r) < 1e-6
    assert validation.orthogonality(q) < 1e-6


@pytest.mark.parametrize("mode,inplace", [("bf16", False), ("fp32", True)])
def test_inpass_metrics_match_jax(mode, inplace):
    # cholqr1: the in-pass residual IS ||A - QR|| / ||A||, read without a
    # second pass; in place (out=a), it is the only residual there is
    a32 = _rand(4096, 64, 6)
    a, aj = _host_a(a32, mode)
    if inplace:
        a, aj = a32.copy(), a32.copy()
    q, r, info = ooc.qr_out_of_core(a, mode, method="cholqr1",
                                    chunk_rows=1024, metrics=True,
                                    out=a if inplace else None, device="cpu")
    _, _, info_j = jooc.qr_out_of_core(aj, mode, method="cholqr1",
                                       chunk_rows=1024, metrics=True,
                                       out=aj if inplace else None)
    for k in ("orthogonality", "residual"):
        assert abs(info[k] - info_j[k]) <= 0.05 * info_j[k] + 1e-7, k
    golden = validation.residual(a32, _f32(q), _f32(r))
    assert abs(info["residual"] - golden) < (1e-3 if mode == "bf16" else 1e-6)
    assert abs(info["orthogonality"]
               - validation.orthogonality(_f32(q))) < 1e-3


def test_streamed_metrics_match_jax():
    a32 = _rand(4096, 64, 4)
    a, aj = _host_a(a32, "bf16")
    q, r = ooc.qr_out_of_core(a, "bf16", method="cholqr1", chunk_rows=1024,
                              device="cpu")
    orth = ooc.ooc_orthogonality(q, chunk_rows=1024, device="cpu")
    resid = ooc.ooc_residual(a, q, r, chunk_rows=1024, device="cpu")
    # JAX's streamed metrics over the same (Q, R), as ml_dtypes arrays
    qj = _f32(q).astype(jnp.bfloat16)
    assert abs(orth - jooc.ooc_orthogonality(qj, chunk_rows=1024)) < 1e-6
    assert abs(resid - jooc.ooc_residual(aj, qj, r.numpy(),
                                         chunk_rows=1024)) < 1e-6
    assert abs(orth - validation.orthogonality(_f32(q))) < 1e-3
    assert abs(resid - validation.residual(a32, _f32(q), r.numpy())) < 1e-3


def _gens(a, chunk, dtype):
    """chunk i of the numpy matrix a, for each package."""
    at = torch.from_numpy(a).to(dtype)
    aj = jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    n = a.shape[1]

    def gen(i):
        return at[i * chunk:(i + 1) * chunk]

    def gen_j(i):
        return jax.lax.dynamic_slice(aj, (i * chunk, 0), (chunk, n))

    return gen, gen_j


@pytest.mark.parametrize("mode,method,dtype", [
    ("fp32", "cholqr2", torch.float32), ("bf16", "cholqr1", torch.bfloat16),
    ("bf16x6_cor", "cholqr3", torch.bfloat16)])
def test_qr_regen_matches_jax(mode, method, dtype):
    m, n, chunk = 4096, 64, 1024
    a = _rand(m, n, 0)
    gen, gen_j = _gens(a, chunk, dtype)
    r, info = ooc.qr_regen(gen, m, n, mode, method=method, chunk_rows=chunk,
                           device="cpu")
    rj, info_j = jooc.qr_regen(gen_j, m, n, mode, method=method,
                               chunk_rows=chunk)
    tol = _tol(mode)
    assert _rel(r, rj) <= tol and _rel(info["rinv"], info_j["rinv"]) <= tol
    grade = 2e-2 if mode == "bf16" else 1e-5
    for k in ("orthogonality", "residual"):
        got, want = float(info[k]), float(info_j[k])
        assert got < grade and abs(got - want) <= 0.1 * want + 1e-7, k
    # a consumer materializes Q chunk by chunk through info["rinv"]
    a_used = _f32(torch.cat([gen(i) for i in range(m // chunk)]))
    q = a_used @ info["rinv"].numpy()
    assert validation.orthogonality(q) < grade
    assert validation.residual(a_used, q, r.numpy()) < grade


def test_qr_regen_cholqr_iter_deep_kappa_and_cheap_dot():
    # the iterated shifted rung, matrix-free, past cholqr3's contract
    m, n, chunk = 4096, 64, 1024
    a, _ = latms.rand_matrix_with_cond(40, m, n, 1e6)
    gen, gen_j = _gens(a, chunk, torch.float32)
    r, info = ooc.qr_regen(gen, m, n, "fp32", method="cholqr_iter",
                           chunk_rows=chunk, device="cpu")
    rj, info_j = jooc.qr_regen(gen_j, m, n, "fp32", method="cholqr_iter",
                               chunk_rows=chunk)
    assert float(info["orthogonality"]) < 1e-5
    assert float(info["residual"]) < 1e-4
    assert float(info_j["orthogonality"]) < 1e-5
    # R of a kappa = 1e6 input: float32 grade relative to ||R||
    assert _rel(r, rj) < 1e-4
    with pytest.raises(ValueError, match="cheap-dot"):
        ooc.qr_regen(gen, m, n, "bf16", method="cholqr_iter",
                     chunk_rows=chunk, device="cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_lstsq_regen_matches_jax(k):
    m, n, chunk = 2048, 24, 256
    a = _rand(m, n, 3)
    b = np.random.default_rng(4).uniform(-1, 1, (m, k)).astype(np.float32)
    b = b[:, 0] if k == 1 else b
    mode = "fp32" if k == 1 else "bf16x6_cor"
    dtype = torch.float32 if k == 1 else torch.bfloat16
    gen, gen_j = _gens(a, chunk, dtype)
    x, info = plstsq.lstsq_regen(gen, torch.from_numpy(b), m, n, mode,
                                 chunk_rows=chunk, device="cpu")
    xj, info_j = jlstsq.lstsq_regen(gen_j, jnp.asarray(b), m, n, mode,
                                    chunk_rows=chunk)
    assert tuple(x.shape) == tuple(xj.shape)
    assert _rel(x, xj) <= _tol(mode)
    assert abs(float(info["residual"]) - float(info_j["residual"])) < 1e-5
    a_used = _f32(torch.cat([gen(i) for i in range(m // chunk)]))
    xg = np.linalg.lstsq(a_used.astype(np.float64), b.astype(np.float64),
                         rcond=None)[0]
    np.testing.assert_allclose(x.numpy(), xg, rtol=1e-3, atol=1e-4)
    assert float(info["orthogonality"]) < 1e-5


def test_uniform_gen_is_order_independent():
    gen = ooc.uniform_gen(7, 256, 16, dtype=torch.float32, device="cpu")
    forward = [gen(i) for i in range(4)]
    backward = [gen(i) for i in reversed(range(4))][::-1]
    for x, y in zip(forward, backward):
        assert torch.equal(x, y)
    assert not torch.equal(forward[0], forward[1])
    assert float(forward[0].min()) >= -1 and float(forward[0].max()) < 1
    assert not torch.equal(forward[0], ooc.uniform_gen(
        8, 256, 16, dtype=torch.float32, device="cpu")(0))
    bf = ooc.uniform_gen(7, 256, 16, device="cpu")(2)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, forward[2].to(torch.bfloat16))


# ---- the checkpoint contract, in the port alone --------------------------

M_CK, N_CK, CHUNK_CK = 4096, 48, 512


@pytest.fixture(scope="module")
def ck_ref():
    a = _rand(M_CK, N_CK, 9)
    q, r, info = ooc.qr_out_of_core(a, "fp32", method="cholqr3",
                                    chunk_rows=CHUNK_CK, metrics=True,
                                    device="cpu")
    return a, q, r, info


def _ck_run(a, out, ck, fault=None):
    return ooc.qr_out_of_core(a, "fp32", method="cholqr3",
                              chunk_rows=CHUNK_CK, metrics=True, out=out,
                              checkpoint=ck, _fault_after=fault,
                              device="cpu")


def _bitwise(got, ref):
    q, r, info = got
    q_ref, r_ref, info_ref = ref
    assert np.array_equal(_f32(q), _f32(q_ref))
    assert torch.equal(r, r_ref)
    assert info["orthogonality"] == info_ref["orthogonality"]
    assert info["residual"] == info_ref["residual"]


def test_checkpointed_run_is_bitwise_the_plain_run(ck_ref, tmp_path):
    a, *ref = ck_ref
    ck = tmp_path / "ck.npz"
    out = np.empty_like(a)
    got = _ck_run(a, out, ck)
    assert got[0] is out and not ck.exists()
    _bitwise(got, ref)


# 8 chunks a pass; checkpointed cholqr3 = 3 Gram passes + 2 chain
# extensions + 1 Q pass = 34 steps: steps 1, 9, 17, 26, 33 hit every phase
@pytest.mark.parametrize("k", [1, 9, 17, 26, 33])
def test_resume_after_a_fault_is_bitwise(ck_ref, tmp_path, k):
    a, *ref = ck_ref
    ck = tmp_path / f"ck{k}.npz"
    out = np.lib.format.open_memmap(tmp_path / "q.npy", "w+", np.float32,
                                    a.shape)
    with pytest.raises(ooc.OOCInterrupted):
        _ck_run(a, out, ck, fault=k)
    assert ck.exists()
    _bitwise(_ck_run(a, out, ck), ref)
    assert not ck.exists()


def test_double_interruption_resumes_bitwise(ck_ref, tmp_path):
    a, *ref = ck_ref
    ck = tmp_path / "ck3.npz"
    out = np.empty_like(a)
    with pytest.raises(ooc.OOCInterrupted):
        _ck_run(a, out, ck, fault=5)
    with pytest.raises(ooc.OOCInterrupted):
        _ck_run(a, out, ck, fault=12)
    _bitwise(_ck_run(a, out, ck), ref)


def test_checkpoint_guards(tmp_path):
    a = _rand(1024, 16, 10)
    ck = tmp_path / "g.npz"
    kw = dict(method="cholqr2", chunk_rows=256, device="cpu")
    with pytest.raises(ValueError, match="separate"):
        ooc.qr_out_of_core(a, "fp32", out=a, checkpoint=ck, **kw)
    with pytest.raises(ValueError, match="separate"):
        ooc.qr_out_of_core(a, "fp32", checkpoint=ck, **kw)
    out = np.empty_like(a)
    with pytest.raises(ooc.OOCInterrupted):
        ooc.qr_out_of_core(a, "fp32", out=out, checkpoint=ck,
                           _fault_after=2, **kw)
    with pytest.raises(ValueError, match="does not match"):
        ooc.qr_out_of_core(a, "fp32", out=out, checkpoint=ck,
                           **{**kw, "chunk_rows": 128})
    with pytest.raises(ValueError, match="does not match"):
        ooc.qr_out_of_core(a[::-1].copy(), "fp32", out=out, checkpoint=ck,
                           **kw)
    with pytest.raises(ValueError, match="does not match"):
        ooc.qr_out_of_core(a, "bf16x6_cor", out=out, checkpoint=ck, **kw)
    with pytest.raises(ValueError, match="out must be"):
        ooc.qr_out_of_core(a, "bf16", out=np.empty_like(a), **kw)
    with pytest.raises(ValueError, match="unknown method"):
        ooc.qr_out_of_core(a, "fp32", method="cholqr9", device="cpu")


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    # the .npz keys are the JAX package's: a factorization the JAX
    # package started and lost finishes in the port
    a = _rand(M_CK, N_CK, 11)
    qj, rj, info_j = jooc.qr_out_of_core(a, "fp32", method="cholqr3",
                                         chunk_rows=CHUNK_CK, metrics=True)
    ck = tmp_path / "jax.npz"
    out = np.empty_like(a)
    with pytest.raises(jooc.OOCInterrupted):
        jooc.qr_out_of_core(a, "fp32", method="cholqr3", chunk_rows=CHUNK_CK,
                            metrics=True, out=out, checkpoint=ck,
                            _fault_after=13)
    q, r, info = _ck_run(a, out, ck)
    assert q is out and not ck.exists()
    assert _rel(q, qj) <= _tol("fp32") and _rel(r, rj) <= _tol("fp32")
    assert abs(info["orthogonality"] - info_j["orthogonality"]) < 1e-6
    assert validation.orthogonality(out) < 1e-6


def test_bf16_host_tensors_and_memmap_views(tmp_path):
    # numpy has no bfloat16: a bf16 io-dtype `out` is a torch bf16 tensor,
    # a disk-backed one a uint16 memmap viewed as bf16
    a32 = _rand(2048, 32, 12)
    a = torch.from_numpy(a32).to(torch.bfloat16)
    mm = np.lib.format.open_memmap(tmp_path / "q.npy", "w+", np.uint16,
                                   a32.shape)
    out = torch.from_numpy(mm).view(torch.bfloat16)
    q, r = ooc.qr_out_of_core(a, "bf16", method="cholqr1", chunk_rows=512,
                              out=out, device="cpu")
    q_plain, r_plain = ooc.qr_out_of_core(a, "bf16", method="cholqr1",
                                          chunk_rows=512, device="cpu")
    assert q is out and torch.equal(q, q_plain) and torch.equal(r, r_plain)
    mm.flush()
    back = torch.from_numpy(np.load(tmp_path / "q.npy")).view(torch.bfloat16)
    assert torch.equal(back, q_plain)
    assert validation.orthogonality(_f32(q)) < 2e-2


def test_precision_harness_raises_without_a_card(monkeypatch):
    from tsqr_tpu_torch.harness import precision
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        precision.run(m=1 << 12, chunk=1 << 11)
