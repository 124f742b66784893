"""The stream kernel on a CUDA card, against its plain PyTorch version.

These tests need a card (the kernel has no CPU mode) and skip without
one.  The file imports no JAX, so on a machine with a card and without
JAX it runs alone:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from tsqr_tpu_torch.core import auto
from tsqr_tpu_torch.ops import gram_stream
from tsqr_tpu_torch.utils import latms, validation

pytestmark = pytest.mark.gpu

N = 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(card, m, n=N, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(-1, 1, (m, n)).astype(np.float32))
    rinv = torch.eye(n) + torch.from_numpy(
        rng.standard_normal((n, n)).astype(np.float32)) / (4 * math.sqrt(n))
    delta = torch.from_numpy(
        (1e-3 * rng.standard_normal((n, n)) / math.sqrt(n)).astype(
            np.float32))
    return a.to(card), rinv.to(card), delta.to(card)


def _rel(x, ref) -> float:
    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


@pytest.mark.parametrize("n", [128, 64, 50])
@pytest.mark.parametrize("mode", ["fp32", "bf16x3_cor", "bf16x6_cor"])
def test_kernel_matches_plain_version(card, mode, n):
    a, rinv, delta = _inputs(card, 1001, n)
    dots = ((rinv, delta), (mode, "bf16x3_cor"))
    kw = dict(residual=(False, True), write_q=True, gram_mode=mode)
    launches = gram_stream.LAUNCHES
    q, p = gram_stream.stream(a, *dots, **kw)
    assert gram_stream.LAUNCHES == launches + 1
    q0, p0 = gram_stream.stream_reference(a, *dots, **kw)
    tol = 1e-5 if mode == "bf16x3_cor" else 1e-6
    assert _rel(q, q0) <= tol
    assert _rel(p + p.T, p0 + p0.T) <= tol
    # a Gram-only launch derives the same x bit for bit
    p1 = gram_stream.stream(a, *dots, residual=(False, True), gram_mode=mode)
    assert torch.equal(p1, p)


def test_bf16_io_and_chained_dots(card):
    a, rinv, _ = _inputs(card, 777)
    ab = a.bfloat16()
    q, p = gram_stream.stream(ab, (rinv,) * 3, ("bf16",) * 3, write_q=True,
                              gram_mode="bf16")
    q0, p0 = gram_stream.stream_reference(ab, (rinv,) * 3, ("bf16",) * 3,
                                          write_q=True, gram_mode="bf16")
    assert q.dtype == torch.bfloat16
    assert _rel(q, q0) <= 4e-3 and _rel(p + p.T, p0 + p0.T) <= 4e-3


def test_kernel_raises_on_what_it_does_not_take(card):
    a, rinv, _ = _inputs(card, 256)
    with pytest.raises(ValueError, match="chunk"):
        gram_stream.stream(a, gram_mode="fp32", chunk=512)
    with pytest.raises(ValueError, match="n <="):
        gram_stream.stream(torch.zeros(512, 256, device=card),
                           gram_mode="fp32")
    with pytest.raises(ValueError, match="at most 3"):
        gram_stream.stream(a, (rinv,) * 4, ("fp32",) * 4, write_q=True)


def test_ladder_tiers_on_card(card):
    for kappa, want in ((1, 1), (1e3, 2), (2 ** 18, 3)):
        a_np = (np.random.default_rng(3).uniform(-1, 1, (8192, N)).astype(
            np.float32) if kappa == 1
            else latms.rand_matrix_with_cond(5, 8192, N, kappa)[0])
        a = torch.from_numpy(a_np).to(card)
        q, r, info = auto.qr_auto_fused(a, "bf16x6_cor", return_info=True)
        assert info["tier"] == want
        assert validation.orthogonality_accurate(q) < 1e-5
        assert validation.residual_accurate(a, q, r) < 1e-5
