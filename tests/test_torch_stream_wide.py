"""The port's stream pass past n = 128 (the wide kernels' range, up to
1024 or 2048 by mode) against the JAX package's stream_pallas in
interpret mode, on the same numpy inputs, for each kind of call.  On the
CPU the port runs the kernels' plain version; tests/test_torch_gpu.py
holds the wide kernels to it on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsqr_tpu.core import cholqr as jcholqr
from tsqr_tpu.ops import pallas_gram
from tsqr_tpu import modes as jmodes
from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import cholqr
from tsqr_tpu_torch.harness import flops
from tsqr_tpu_torch.ops import gram_stream

torch.set_num_threads(2)

SHAPES = [(1024, 192), (1024, 256), (1024, 1024)]
MODES = ["fp32", "bf16x3_cor", "bf16x6_cor", "bf16"]
# each kind: (dots as (operand, mode), "md" the call's mode; residual
# flags; write_q; Gram; alias_q; A in bf16 whatever the mode)
KINDS = {
    "gram_only": ((), (), False, True, False, False),
    "qpass": ((("rinv", "md"),), (), True, False, False, False),
    "dot_gram": ((("rinv", "md"),), (), False, True, False, False),
    "chain3": ((("rinv", "md"),) * 3, (), True, False, False, False),
    "residual": ((("rinv", "md"), ("delta", "bf16x3_cor")), (False, True),
                 True, True, False, False),
    "alias_q": ((("rinv", "md"), ("delta", "bf16x3_cor")), (False, True),
                True, False, True, False),
    "bf16_a": ((("rinv", "md"),), (), True, True, False, True),
}


def _inputs(m, n, seed=0):
    rng = np.random.default_rng(seed + n)
    a = rng.uniform(-1, 1, (m, n)).astype(np.float32)
    rinv = (np.eye(n) + rng.standard_normal((n, n)) / (4 * np.sqrt(n))
            ).astype(np.float32)
    delta = (1e-3 * rng.standard_normal((n, n)) / np.sqrt(n)).astype(
        np.float32)
    return a, rinv, delta


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wide_stream_matches_pallas(kind, mode, m, n):
    a, rinv, delta = _inputs(m, n)
    ops = {"rinv": rinv, "delta": delta}
    dots, residual, write_q, with_gram, alias_q, bf16_a = KINDS[kind]
    rinvs = tuple(ops[o] for o, _ in dots)
    dmodes = tuple(mode if d == "md" else d for _, d in dots)
    gmode = mode if with_gram else None
    bf16_in = mode == "bf16" or bf16_a
    if bf16_in:  # both packages read the same bf16 values
        a = np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
            jnp.float32))
    in_j = jnp.bfloat16 if bf16_in else jnp.float32
    in_t = torch.bfloat16 if bf16_in else torch.float32
    # Q in the IO type of the mode; alias_q writes it over A
    out_j = jnp.bfloat16 if mode == "bf16" else in_j if alias_q \
        else jnp.float32
    out_t = torch.bfloat16 if mode == "bf16" else in_t if alias_q \
        else torch.float32

    ref = pallas_gram.stream_pallas(
        jnp.asarray(a).astype(in_j), tuple(map(jnp.asarray, rinvs)), dmodes,
        write_q=write_q, gram_mode=gmode, chunk=gram_stream.GRAM_CHUNK,
        interpret=True, residual=residual, out_dtype=out_j, alias_q=alias_q)
    at = torch.from_numpy(a).to(in_t)
    got = gram_stream.stream(
        at, tuple(map(torch.from_numpy, rinvs)), dmodes, write_q=write_q,
        gram_mode=gmode, residual=residual, out_dtype=out_t, alias_q=alias_q)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    # the tolerances of tests/test_torch_stream.py at n <= 128: each mode's
    # class (bf16 output rounds at 2^-8; three 3-pass products differ by
    # ordering alone at ~1e-6, inside the mode's 2^-16 grade)
    tol = {"bf16": 4e-3, "bf16x3_cor": 1e-5}.get(mode, 1e-6)
    if write_q:
        q = got[0]
        assert q.dtype == out_t and tuple(q.shape) == (m, n)
        if alias_q:
            assert q.data_ptr() == at.data_ptr()
        assert _rel(q.float().numpy(), np.asarray(ref[0], np.float32)) <= tol
    if with_gram:
        p, pj = got[-1].numpy(), np.asarray(ref[-1])
        assert _rel(p + p.T, pj + pj.T) <= tol


@pytest.mark.parametrize("mode", ["fp32", "bf16", "bf16_nocor",
                                  "bf16x3_nocor", "bf16x3_cor",
                                  "bf16x6_cor", "bf16x3_cor_emu"])
def test_fused_n_max_is_jax(mode):
    """The fused range at every mode is the JAX package's: 1024 for the
    multi-part corrected modes, 2048 for the others.  The stream pass
    itself takes every in-kernel mode up to 2048 (the fp32 pipelines'
    bf16x3_cor corrections run there) and raises past it."""
    want = jcholqr._fused_n_max(jmodes.resolve(mode))
    assert cholqr._fused_n_max(modes.resolve(mode)) == want
    if mode in ("bf16x3_cor_emu",):
        return
    wide = gram_stream.WIDE_N_MAX
    with pytest.raises(ValueError, match=f"n <= {wide}"):
        gram_stream.stream(torch.zeros(wide + 16, wide + 8), gram_mode=mode)
    # past 1024 at every mode, as the JAX package's kernel computes it
    a, rinv, _ = _inputs(1040, 1032)
    p = gram_stream.stream(torch.from_numpy(a), (torch.from_numpy(rinv),),
                           (mode,), gram_mode=mode)
    pj = np.asarray(pallas_gram.stream_pallas(
        jnp.asarray(a), (jnp.asarray(rinv),), (mode,), gram_mode=mode,
        chunk=gram_stream.GRAM_CHUNK, interpret=True))
    tol = {"bf16": 4e-3, "bf16_nocor": 4e-3, "bf16x3_nocor": 1e-5,
           "bf16x3_cor": 1e-5}.get(mode, 1e-6)
    assert _rel(p.numpy() + p.numpy().T, pj + pj.T) <= tol


def test_wide_stream_dispatches_cpu_tensor_to_plain_version():
    a, rinv, _ = _inputs(1001, 256)
    at, rt = torch.from_numpy(a), torch.from_numpy(rinv)
    counts = (gram_stream.WIDE_LAUNCHES, gram_stream.WIDE_GRAM_LAUNCHES,
              gram_stream.REDUCE_LAUNCHES, gram_stream.LAUNCHES)
    kw = dict(write_q=True, gram_mode="bf16x6_cor")
    q, p = gram_stream.stream(at, (rt,), ("bf16x6_cor",), **kw)
    q0, p0 = gram_stream.stream_reference(at, (rt,), ("bf16x6_cor",), **kw)
    assert torch.equal(q, q0) and torch.equal(p, p0)
    assert (gram_stream.WIDE_LAUNCHES, gram_stream.WIDE_GRAM_LAUNCHES,
            gram_stream.REDUCE_LAUNCHES, gram_stream.LAUNCHES) == counts


def test_wide_chunk_and_bound():
    """Past n = 128 the Gram compensates every WIDE_CHUNK_ROWS rows (the
    JAX package's chunk at n = 1024); the bound counts the function's
    bytes, and the design's bound what the wide kernels move besides."""
    assert gram_stream.effective_chunk(1 << 20, 1024) == 1024
    assert gram_stream.effective_chunk(1 << 20, 129) == 1024
    assert gram_stream.effective_chunk(1 << 20, 128) == 4096
    assert gram_stream.effective_chunk(700, 512) == 700
    assert pallas_gram.effective_chunk(1 << 20, 1024) == 1024
    m, n = 1 << 19, 512
    g = flops.stream_bound(m, n, gram_mode="bf16x6_cor")
    assert g["bytes"] == 4 * m * n + 4 * n * n
    assert g["bound_by"] == "operations"
    kw = dict(dot_modes=("bf16x6_cor",), gram_mode="bf16x6_cor",
              write_q=True)
    both = flops.stream_bound(m, n, **kw)
    dot = flops.stream_bound(m, n, ("bf16x6_cor",), write_q=True)
    # the function's least traffic: A read, Q and P written once
    assert both["bytes"] == dot["bytes"] + 4 * n * n
    # the design's: each product's three bf16 parts written and read once
    # (12 bytes a value), and the Gram reads Q, float32 x, once more
    design = flops.stream_bound(m, n, design=True, **kw)
    assert design["bytes"] == both["bytes"] + (12 + 12 + 4) * m * n
    # a bf16 Q: x goes to scratch (written, and read by the store)
    x6 = ("bf16x6_cor",)
    assert flops.wide_extra_bytes(m, n, x6, "bf16x6_cor", True,
                                  torch.bfloat16) == (12 + 12 + 4 + 8) * m * n
    # a chain of three fp32 dots: two float32 intermediates written and read
    assert flops.wide_extra_bytes(m, n, ("fp32",) * 3, None, True) == (
        16 * m * n)
    assert flops.wide_extra_bytes(1 << 20, 128, x6, "bf16x6_cor") == 0
    narrow = flops.stream_bound(1 << 20, 128, design=True, **kw)
    assert narrow["bytes"] == (8 << 27) + 8 * 128 * 128
