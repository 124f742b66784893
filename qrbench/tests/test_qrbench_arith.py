"""The frozen arithmetic, pinned to the numbers PERF.md quotes."""

import math

import pytest

from qrbench import arith


def test_stream_bound_tall128_tier1():
    """(2^20, 128) bf16x6_cor: the Gram pass and the Q pass, 0.481 ms."""
    m, n = 1 << 20, 128
    gram = arith.stream_bound(m, n, gram_mode="bf16x6_cor")
    qpass = arith.stream_bound(m, n, ("bf16x6_cor",), write_q=True)
    assert gram["bound_by"] == qpass["bound_by"] == "bytes"
    assert gram["bound_ms"] + qpass["bound_ms"] == pytest.approx(0.481,
                                                                 abs=5e-4)


def test_stream_bound_wide512_tier1():
    """(2^19, 512) bf16x6_cor: 1.112 ms (Gram) + 1.668 ms (Q pass), both
    bound by operations."""
    m, n = 1 << 19, 512
    gram = arith.stream_bound(m, n, gram_mode="bf16x6_cor")
    qpass = arith.stream_bound(m, n, ("bf16x6_cor",), write_q=True)
    assert gram["bound_by"] == qpass["bound_by"] == "operations"
    assert gram["bound_ms"] == pytest.approx(1.112, abs=5e-4)
    assert qpass["bound_ms"] == pytest.approx(1.668, abs=5e-4)


def test_panel_bound_tile():
    """The (4096, 256, 128) panel tile in bf16x6_cor: 0.401 ms, bytes."""
    b = arith.panel_bound(4096, 256, 128, "bf16x6_cor")
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.401, abs=5e-4)


def test_qr_flops_and_peaks():
    assert arith.qr_flops(1 << 20, 128) == pytest.approx(
        4 * 2 ** 20 * 128 ** 2 - 2 * 128 ** 3 / 3)
    assert arith.H100_BYTES_PER_S == 3.35e12
    assert arith.H100_BF16_FLOPS == 989e12
    assert arith.H100_FP32_FLOPS == 67e12


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 1), (0.5, 0.75)], 2.0),
    ([(0, 10), (2, 3)], 10.0),
])
def test_union_length(spans, want):
    assert math.isclose(arith.union_length(spans), want)
