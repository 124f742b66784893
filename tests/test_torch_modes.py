"""tsqr_tpu_torch.modes against tsqr_tpu.modes on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsqr_tpu import modes as jmodes
from tsqr_tpu_torch import modes

torch.set_num_threads(2)

_RNG = np.random.default_rng(0)
A = _RNG.uniform(-1, 1, (64, 48)).astype(np.float32)
B = _RNG.uniform(-1, 1, (48, 32)).astype(np.float32)


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("mode", [m.value for m in modes.ALL_MODES])
def test_mm_matches_jax(mode):
    got = modes.resolve(mode).mm(_t(A), _t(B)).numpy()
    if mode == "bf16x3_nocor":
        # JAX's CPU Precision.HIGH is plain float32; the port runs the
        # 3-pass split, so it is held to its 1e-3 class against float64
        ref = A.astype(np.float64) @ B.astype(np.float64)
        assert _rel(got, ref) <= 1e-3
        return
    ref = np.asarray(jmodes.resolve(mode).mm(jnp.asarray(A), jnp.asarray(B)))
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("mode", [m.value for m in modes.ALL_MODES])
def test_gram_matches_jax(mode):
    got = modes.gram(_t(A), modes.resolve(mode)).numpy()
    if mode == "bf16x3_nocor":
        ref = A.T.astype(np.float64) @ A.astype(np.float64)
        assert _rel(got, ref) <= 1e-3
        return
    ref = np.asarray(jmodes.gram(jnp.asarray(A), jmodes.resolve(mode)))
    assert _rel(got, ref) <= 1e-6


def test_mm_3term_matches_jax():
    got = modes.mm_bf16x3_cor_3term(_t(A), _t(B)).numpy()
    ref = np.asarray(jmodes.mm_bf16x3_cor_3term(jnp.asarray(A),
                                                jnp.asarray(B)))
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("bits", [7, 10, 23])
def test_clip_mantissa_bit_identical(bits):
    special = np.array([0.0, -0.0, 1.0, -1.5, np.inf, -np.inf, np.nan,
                        3.4028235e38, -3.4028235e38, 1e-45, 1.1754944e-38,
                        1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -9],
                       np.float32)
    x = np.concatenate([A.ravel() * 1e3, special])
    got = modes.clip_mantissa(_t(x), bits).numpy()
    ref = np.asarray(jmodes.clip_mantissa(jnp.asarray(x), bits))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_splits_bit_identical():
    for got, ref in ((modes.split2(_t(A)), jmodes.split2(jnp.asarray(A))),
                     (modes.split3(_t(A)), jmodes.split3(jnp.asarray(A)))):
        for g, r in zip(got, ref):
            r32 = np.asarray(r.astype(jnp.float32))
            assert np.array_equal(g.numpy().view(np.uint32),
                                  r32.view(np.uint32))


def test_fp32_matmul_is_pinned_to_true_fp32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_policies_mirror_jax():
    for m in modes.ALL_MODES:
        p, jp = modes.resolve(m.value), jmodes.resolve(m.value)
        assert p.mode.value == jp.mode.value
        assert p.io_dtype == getattr(torch, jnp.dtype(jp.io_dtype).name)
        assert p.work_dtype == getattr(torch, jnp.dtype(jp.work_dtype).name)
        assert p.corrected == jp.corrected
        assert (p.trailing_mm is modes.mm_fp32) == (
            jp.trailing_mm is jmodes.mm_fp32)
    assert modes.resolve(modes.resolve("fp32")) is modes.resolve("fp32")
    with pytest.raises(ValueError):
        modes.resolve("fp64")
