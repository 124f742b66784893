"""The port's stream pass (ops/gram_stream.py) against the JAX package's
stream_pallas in interpret mode, on the same numpy inputs, for each way
the ladder calls it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu.ops import pallas_gram
from tsqr_tpu_torch.core import cholqr
from tsqr_tpu_torch.harness import flops
from tsqr_tpu_torch.ops import gram_stream
from tsqr_tpu_torch.utils import trace


N = 128
CHUNK = gram_stream.GRAM_CHUNK  # the kernel's chunk, in both packages


def _inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (m, N)).astype(np.float32)
    rinv = (np.eye(N) + rng.standard_normal((N, N)) / (4 * np.sqrt(N))
            ).astype(np.float32)
    delta = (1e-3 * rng.standard_normal((N, N)) / np.sqrt(N)).astype(
        np.float32)
    return a, rinv, delta


# the call sites of the ladder: (dots as (operand, mode) with "md" = the
# pipeline's mode, residual flags, write_q, gram at the pipeline's mode)
CALL_SITES = {
    "gram_only": ((), (), False, True),                     # tier 0, gate
    "tier1_qpass": ((("rinv", "md"),), (), True, False),
    "compact_mid": ((("rinv", "bf16x3_cor"),), (), False, True),
    "compact_f2": ((("rinv", "md"),), (), False, True),
    "compact_final": ((("rinv", "md"), ("delta", "bf16x3_cor")),
                      (False, True), True, True),
    "cheap_chain": ((("rinv", "md"),) * 3, (), True, False),
}


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("m", [2048, 1001])
@pytest.mark.parametrize("mode", ["fp32", "bf16x3_cor", "bf16x6_cor", "bf16"])
@pytest.mark.parametrize("site", sorted(CALL_SITES))
def test_stream_reference_matches_pallas(site, mode, m):
    a, rinv, delta = _inputs(m)
    ops = {"rinv": rinv, "delta": delta}
    dots, residual, write_q, with_gram = CALL_SITES[site]
    rinvs = tuple(ops[o] for o, _ in dots)
    dmodes = tuple(mode if d == "md" else d for _, d in dots)
    gmode = mode if with_gram else None
    io_np = np.float32
    if mode == "bf16":  # bf16 IO: both packages read and write bf16
        a = np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
            jnp.float32))
    io_j = jnp.bfloat16 if mode == "bf16" else jnp.float32
    io_t = torch.bfloat16 if mode == "bf16" else torch.float32

    ref = pallas_gram.stream_pallas(
        jnp.asarray(a).astype(io_j), tuple(map(jnp.asarray, rinvs)), dmodes,
        write_q=write_q, gram_mode=gmode, chunk=CHUNK, interpret=True,
        residual=residual, out_dtype=io_j)
    got = gram_stream.stream_reference(
        torch.from_numpy(a).to(io_t), tuple(map(torch.from_numpy, rinvs)),
        dmodes, write_q=write_q, gram_mode=gmode, chunk=CHUNK,
        residual=residual, out_dtype=io_t)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    # each mode's class: bf16 output rounds at 2^-8; a chain of three
    # 3-pass products differs by ordering alone at ~1e-6, inside the
    # mode's 2^-16 grade
    tol = {"bf16": 4e-3, "bf16x3_cor": 1e-5}.get(mode, 1e-6)
    if write_q:
        q, qj = got[0], ref[0]
        assert q.dtype == io_t and tuple(q.shape) == (m, N)
        assert _rel(q.float().numpy(), np.asarray(qj, io_np)) <= tol
    if with_gram:
        p, pj = got[-1].numpy(), np.asarray(ref[-1])
        assert _rel(p + p.T, pj + pj.T) <= tol


def test_stream_dispatches_cpu_tensor_to_plain_version():
    a, rinv, _ = _inputs(1001)
    at, rt = torch.from_numpy(a), torch.from_numpy(rinv)
    before = trace.counts("launches.")
    kw = dict(write_q=True, gram_mode="bf16x6_cor")
    q, p = gram_stream.stream(at, (rt,), ("bf16x6_cor",), **kw)
    q0, p0 = gram_stream.stream_reference(at, (rt,), ("bf16x6_cor",), **kw)
    assert torch.equal(q, q0) and torch.equal(p, p0)
    assert trace.counts("launches.") == before


@pytest.mark.parametrize("chunk", [CHUNK, 512])
def test_gram_and_qpass_wrappers_match_pallas(chunk):
    """At the kernel's chunk (one chunk at this m) and at 512 rows, where
    the compensated sum runs over four chunks."""
    a, rinv, _ = _inputs(2048, seed=1)
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    g = gram_stream.gram_stream(at, "bf16x6_cor", chunk=chunk).numpy()
    gj = np.asarray(pallas_gram.gram_pallas(aj, "bf16x6_cor", chunk=chunk,
                                            interpret=True))
    assert _rel(g, gj) <= 1e-6
    q, g2 = gram_stream.qpass_stream(at, torch.from_numpy(rinv), "fp32",
                                     chunk=chunk)
    qj, g2j = pallas_gram.qpass_pallas(aj, jnp.asarray(rinv), "fp32",
                                       chunk=chunk, interpret=True)
    assert _rel(q.numpy(), np.asarray(qj)) <= 1e-6
    assert _rel(g2.numpy(), np.asarray(g2j)) <= 1e-6


def test_stream_rejects_bad_calls():
    at = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="write_q or gram_mode"):
        gram_stream.stream(at)
    with pytest.raises(ValueError, match="one mode per dot"):
        gram_stream.stream(at, (torch.eye(8),), (), write_q=True)
    with pytest.raises(ValueError):
        gram_stream.stream(at, gram_mode="bf16x3_cor_emu")


def test_effective_chunk_and_bound():
    assert gram_stream.GRAM_CHUNK == gram_stream.DEFAULT_CHUNK == 4096
    assert gram_stream.effective_chunk(1 << 20, 128) == 4096
    assert gram_stream.effective_chunk(1001, 128) == 1001
    assert gram_stream.effective_chunk(5, 128, 512) == 5
    assert gram_stream.TILE_ROWS == 64
    assert gram_stream.CHUNK_ROWS % gram_stream.TILE_ROWS == 0
    # the Gram at the bench shape reads 512 MiB: >= 0.16 ms on an H100
    b = flops.stream_bound(1 << 20, 128, gram_mode="bf16x6_cor")
    assert b["bytes"] == (1 << 29) + 4 * 128 * 128
    assert b["bound_by"] == "bytes" and 0.160 < b["bound_ms"] < 0.161
    q = flops.stream_bound(1 << 20, 128, ("bf16x6_cor",), write_q=True)
    assert 0.32 < q["bound_ms"] < 0.33
    f = flops.stream_bound(1 << 20, 128, ("fp32",), write_q=True)
    assert f["bound_by"] == "operations"


@pytest.mark.parametrize("method", ["cholqr3_fused", "cholqr_iter_fused"])
def test_shift_budgets_the_kernels_chunk(monkeypatch, method):
    """The fused shift is fed the chunk the kernel sums before each
    compensated add (CHUNK_ROWS), clamped to m as the plain version
    clamps it."""
    seen = []
    shift = cholqr._shift_value_fused
    monkeypatch.setattr(cholqr, "_shift_value_fused",
                        lambda g, n, chunk: seen.append(chunk) or shift(
                            g, n, chunk))
    for m in (4500, 300):
        a = np.random.default_rng(m).uniform(-1, 1, (m, 8))
        a[:, 3] = 0.0  # a zero column: every pass of the loop is shifted
        getattr(cholqr, method)(torch.from_numpy(a.astype(np.float32)),
                                "bf16x6_cor")
        assert seen and set(seen) == {min(m, gram_stream.CHUNK_ROWS)}
        seen.clear()
