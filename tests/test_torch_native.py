"""The port's native C++ emulation cores (tsqr_tpu_torch/utils/native.py,
built from its own copy of csrc/emu_gemm.cpp) against the port's precision
policies (tsqr_tpu_torch/modes.py) and against the JAX package's build of
the same source (tsqr_tpu/utils/native.py): the four cases of
tests/test_native_emu.py, on the CPU."""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu.utils import native as jnative
from tsqr_tpu_torch import modes
from tsqr_tpu_torch.utils import native


@pytest.fixture(scope="module", autouse=True)
def _build():
    native._load()
    jnative._load()


def _emu(fn, a, b) -> np.ndarray:
    return fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def test_clip_mantissa_cross_language():
    rng = np.random.default_rng(0)
    xs = rng.uniform(-4, 4, 256).astype(np.float32)
    for bits in (7, 10):
        tx = modes.clip_mantissa(torch.from_numpy(xs), bits).numpy()
        cx = np.array([native.clip_mantissa_scalar(float(x), bits)
                       for x in xs], np.float32)
        jx = np.array([jnative.clip_mantissa_scalar(float(x), bits)
                       for x in xs], np.float32)
        np.testing.assert_array_equal(tx, cx)
        np.testing.assert_array_equal(cx, jx)


def test_nocor_gemm_matches_torch_emulator():
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (32, 48)).astype(np.float32)
    b = rng.uniform(-1, 1, (48, 24)).astype(np.float32)
    cpp = native.emu_gemm_nocor(a, b, bits=7)
    tx = _emu(modes.mm_bf16_nocor_emu, a, b)
    # C++ sums in order, torch's matmul in blocks: float32 round-off, far
    # below the bf16-grade signal (~4e-3)
    assert np.max(np.abs(cpp - tx)) < 1e-4
    exact = a.astype(np.float64) @ b.astype(np.float64)
    e_cpp, e_tx = np.abs(cpp - exact).max(), np.abs(tx - exact).max()
    assert 0.25 < e_cpp / e_tx < 4.0
    # the same source with the same flags: the JAX package's build agrees
    np.testing.assert_array_equal(cpp, jnative.emu_gemm_nocor(a, b, bits=7))


def test_cor_gemm_matches_torch_emulator():
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (16, 64)).astype(np.float32)
    b = rng.uniform(-1, 1, (64, 16)).astype(np.float32)
    cpp = native.emu_gemm_cor(a, b, bits=7)
    tx = _emu(modes.mm_bf16x3_cor_emu, a, b)
    assert np.max(np.abs(cpp - tx)) < 1e-5
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(cpp - exact).max() < 1e-4  # corrected grade
    np.testing.assert_array_equal(cpp, jnative.emu_gemm_cor(a, b, bits=7))


def test_mixed_gemm_runs():
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (8, 32)).astype(np.float32)
    b = rng.uniform(-1, 1, (32, 8)).astype(np.float32)
    cpp = native.emu_gemm_mixed(a, b, bits=7)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(cpp - exact).max() < 1e-4
    assert np.max(np.abs(cpp - _emu(modes.mm_mixed_cor_emu, a, b))) < 1e-5
    np.testing.assert_array_equal(cpp, jnative.emu_gemm_mixed(a, b, bits=7))
    with pytest.raises(ValueError):
        native.emu_gemm_mixed(a, a, bits=7)
