"""The stream and panel kernels on a CUDA card, against their plain
PyTorch versions, and the ladder's tiers on the card.

These tests need a card (the kernels have no CPU mode) and skip without
one.  The file imports no JAX, so on a machine with a card and without
JAX it runs alone:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from tsqr_tpu_torch.core import auto
from tsqr_tpu_torch.ops import bw_probe, gram_stream, panel_kernel
from tsqr_tpu_torch.utils import latms, validation

pytestmark = pytest.mark.gpu

N = 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
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


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
def test_alias_q_writes_q_over_a(card, io):
    a, rinv, delta = _inputs(card, 1001)
    a = a.to(io)
    mode = "bf16x6_cor" if io == torch.float32 else "bf16"
    dots = ((rinv, delta), (mode, "bf16x3_cor"))
    kw = dict(residual=(False, True), write_q=True, gram_mode=mode)
    q0, p0 = gram_stream.stream(a, *dots, **kw)
    a1 = a.clone()
    q1, p1 = gram_stream.stream(a1, *dots, alias_q=True, **kw)
    assert q1.data_ptr() == a1.data_ptr() and q1.dtype == io
    assert torch.equal(q1, q0) and torch.equal(a1, q0) and torch.equal(p1, p0)
    with pytest.raises(ValueError, match="contiguous"):
        gram_stream.stream(a.T, (rinv,), (mode,), write_q=True, alias_q=True)


def test_bf16_io_and_chained_dots(card):
    a, rinv, _ = _inputs(card, 777)
    ab = a.bfloat16()
    q, p = gram_stream.stream(ab, (rinv,) * 3, ("bf16",) * 3, write_q=True,
                              gram_mode="bf16")
    q0, p0 = gram_stream.stream_reference(ab, (rinv,) * 3, ("bf16",) * 3,
                                          write_q=True, gram_mode="bf16")
    assert q.dtype == torch.bfloat16
    assert _rel(q, q0) <= 4e-3 and _rel(p + p.T, p0 + p0.T) <= 4e-3


# every mode with its tolerance against the plain version: fp32 and the
# three-part split at float32 grade, the two-part splits at 2^-16 grade,
# one bf16 part at its output rounding
EDGE_TOL = {"fp32": 1e-6, "bf16x6_cor": 1e-6, "bf16x3_cor": 1e-5,
            "bf16x3_nocor": 1e-5, "bf16": 4e-3, "bf16_nocor": 4e-3}
CHUNK = gram_stream.CHUNK_ROWS


@pytest.mark.parametrize("n", [128, 64, 50, 8])
@pytest.mark.parametrize("m", [5, 1001, CHUNK + 1, 5 * CHUNK + 77])
def test_kernel_edges_match_plain_version(card, m, n):
    """Below one tile, a ragged tile, one chunk and a row, several pairs
    of CTAs; n below and off the mma tile; every mode, one to three dots
    with residual steps; Gram-only against Q-writing bit for bit."""
    a, rinv, delta = _inputs(card, m, n, seed=m + n)
    for mode, tol in EDGE_TOL.items():
        io = torch.bfloat16 if mode.startswith("bf16") and tol > 1e-4 \
            else torch.float32
        x = a.to(io)
        for k in (1, 2, 3):
            rinvs = ((rinv, delta, delta)[:k])
            kw = dict(residual=(False, True, True)[:k], gram_mode=mode)
            dm = (mode,) * k
            q, p = gram_stream.stream(x, rinvs, dm, write_q=True, **kw)
            q0, p0 = gram_stream.stream_reference(x, rinvs, dm, write_q=True,
                                                  **kw)
            assert q.dtype == io and q.shape == (m, n)
            assert _rel(q, q0) <= tol, (mode, k)
            assert _rel(p + p.T, p0 + p0.T) <= tol, (mode, k)
            assert torch.equal(gram_stream.stream(x, rinvs, dm, **kw), p)
            # and a launch without a Gram derives the same Q
            assert torch.equal(gram_stream.stream(
                x, rinvs, dm, write_q=True, residual=kw["residual"]), q)
        g = gram_stream.gram_stream(x, mode)
        g0 = gram_stream.stream_reference(x, gram_mode=mode)
        assert _rel(g, g0 + g0.T) <= tol, mode


@pytest.mark.parametrize("m", [1001, 5 * CHUNK + 77])
def test_alias_q_bitwise_at_edges(card, m):
    a, rinv, delta = _inputs(card, m, 50, seed=3)
    for gram in (None, "bf16x6_cor"):
        kw = dict(residual=(False, True), write_q=True, gram_mode=gram)
        dots = ((rinv, delta), ("bf16x6_cor", "bf16x3_cor"))
        ref = gram_stream.stream(a, *dots, **kw)
        a1 = a.clone()
        got = gram_stream.stream(a1, *dots, alias_q=True, **kw)
        ref, got = (ref, got) if gram else ((ref,), (got,))
        assert got[0].data_ptr() == a1.data_ptr()
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


def test_reduce_stage_repeats_and_matches_sum(card):
    gen = torch.Generator(device=card).manual_seed(7)
    part = torch.randn(66, N, N, dtype=torch.float64, device=card,
                       generator=gen)
    out = gram_stream.reduce_partials(part)
    assert torch.equal(out, gram_stream.reduce_partials(part))
    s = part.sum(0)
    # both sum in float64, in other orders: one float32 rounding apart
    assert bool(((out.double() - s).abs()
                 <= 2.0 ** -24 * s.abs() + 1e-12).all())


def test_kernel_raises_on_what_it_does_not_take(card):
    a, rinv, _ = _inputs(card, 256)
    with pytest.raises(ValueError, match="chunk"):
        gram_stream.stream(a, gram_mode="fp32", chunk=512)
    with pytest.raises(ValueError, match="n <="):
        gram_stream.stream(torch.zeros(512, 256, device=card),
                           gram_mode="fp32")
    with pytest.raises(ValueError, match="at most 3"):
        gram_stream.stream(a, (rinv,) * 4, ("fp32",) * 4, write_q=True)


def _tiles(card, b, L, n, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (b, L, n)).astype(
        np.float32)).to(card)


@pytest.mark.parametrize("n", [128, 64, 50])
@pytest.mark.parametrize("mode", ["fp32", "bf16x3_cor", "bf16x6_cor"])
def test_panel_kernel_matches_plain_version(card, mode, n):
    L = 256 if n > 50 else 200
    a = _tiles(card, 12, L, n)
    a[:, :, 3] = 0.0           # a zero column: H = I
    a[:, L - 40:, :] = 0.0     # zero rows below every pivot
    launches = panel_kernel.LAUNCHES
    qt, r = panel_kernel.panel_qr_batched(a, mode)
    assert panel_kernel.LAUNCHES == launches + 1
    qt0, r0 = panel_kernel.panel_qr_reference(a, mode)
    # the two sum in other orders; Q and R of these well-conditioned
    # tiles move by a few ulps of the mode times sqrt(L)
    tol = 1e-4 if mode == "bf16x3_cor" else 1e-5
    assert _rel(r, r0) <= tol and _rel(qt, qt0) <= tol
    assert torch.equal(torch.tril(r, -1), torch.zeros_like(r))
    assert bool((qt[:, :, L - 40:] == 0).all())
    for t in range(a.shape[0]):
        q = qt[t].T
        assert validation.orthogonality_accurate(q) < tol
        assert validation.residual_accurate(a[t], q, r[t]) < tol


# the kernel against its plain version: the two sum in other orders
# (tensor-core fragments and warp butterflies against batched matmuls);
# at the one-part bf16 modes a changed float32 sum can round a later
# split differently, so those are held to the modes' own grade
PANEL_MODES = {"fp32": 1e-5, "bf16x6_cor": 1e-5, "bf16x3_cor": 1e-4,
               "bf16x3_nocor": 1e-4, "bf16": 5e-2, "bf16_nocor": 5e-2}


@pytest.mark.parametrize("mode", list(PANEL_MODES))
@pytest.mark.parametrize("rows", ["n", "2n", "max"])
@pytest.mark.parametrize("n", [1, 16, 50, 64, 128])
def test_panel_kernel_shapes_and_modes(card, n, rows, mode):
    L = {"n": n, "2n": 2 * n, "max": panel_kernel.max_leaf_rows(n)}[rows]
    a = _tiles(card, 6, L, n, seed=n + L)
    qt, r = panel_kernel.panel_qr_batched(a, mode)
    qt0, r0 = panel_kernel.panel_qr_reference(a, mode)
    tol = PANEL_MODES[mode]
    assert _rel(r, r0) <= tol and _rel(qt, qt0) <= tol
    assert torch.equal(torch.tril(r, -1), torch.zeros_like(r))
    for t in range(a.shape[0]):
        q = qt[t].T
        assert validation.orthogonality_accurate(q) < tol
        assert validation.residual_accurate(a[t], q, r[t]) < tol


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor", "bf16"])
def test_panel_kernel_zero_column_and_zero_rows(card, mode):
    a = _tiles(card, 33, 200, 50, seed=7)
    a[:, :, 9] = 0.0           # a zero column passes as H = I
    a[:, 150:, :] = 0.0        # zero rows give exactly zero Q rows
    qt, r = panel_kernel.panel_qr_batched(a, mode)
    assert bool((qt[:, :, 150:] == 0).all())
    assert bool((r[:, 9, 9] == 0).all())
    assert bool(torch.isfinite(qt).all() and torch.isfinite(r).all())
    tol = PANEL_MODES[mode]
    for t in range(a.shape[0]):
        assert validation.residual_accurate(a[t], qt[t].T, r[t]) < tol


def test_panel_kernel_holds_the_tier4_leaf(card):
    # plan_tree never builds leaves under 2n rows: tier 4 at n = 128 needs
    # (256, 128) tiles
    assert panel_kernel.max_leaf_rows(128) >= 256
    a = _tiles(card, 4, 256, 128, seed=8)
    qt, r = panel_kernel.panel_qr_batched(a, "bf16x6_cor")
    qt0, r0 = panel_kernel.panel_qr_reference(a, "bf16x6_cor")
    assert _rel(r, r0) <= 1e-5 and _rel(qt, qt0) <= 1e-5


def test_panel_kernel_raises_on_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="n <="):
        panel_kernel.panel_qr_batched(_tiles(card, 2, 512, 160), "fp32")
    too_tall = panel_kernel.max_leaf_rows(128) + 8
    with pytest.raises(ValueError, match="holds L <="):
        panel_kernel.panel_qr_batched(_tiles(card, 2, too_tall, 128), "fp32")
    with pytest.raises(ValueError, match="in-kernel mode"):
        panel_kernel.panel_qr_batched(_tiles(card, 2, 256, 128),
                                      "bf16x3_cor_emu")


def test_ladder_tiers_on_card(card):
    for kappa, want in ((1, 1), (1e3, 2), (2 ** 18, 3), (0, 4)):
        a_np = (np.random.default_rng(3).uniform(-1, 1, (8192, N)).astype(
            np.float32) if kappa in (0, 1)
            else latms.rand_matrix_with_cond(5, 8192, N, kappa)[0])
        if kappa == 0:
            a_np[:, 33] = 0.0  # a zero column defeats every Gram tier
        a = torch.from_numpy(a_np).to(card)
        launches = panel_kernel.LAUNCHES
        q, r, info = auto.qr_auto_fused(a, "bf16x6_cor", return_info=True)
        assert info["tier"] == want
        if want == 4:  # two trees (CGS2), one leaf launch each
            assert panel_kernel.LAUNCHES == launches + 2
        assert validation.orthogonality_accurate(q) < 1e-5
        assert validation.residual_accurate(a, q, r) < 1e-5


@pytest.mark.parametrize("rows_per_cta", [8, 4096])
@pytest.mark.parametrize("m,n", [(1 << 16, 128), (1000, 100), (336, 7)])
def test_probes_match_plain_versions(card, m, n, rows_per_cta):
    a = torch.from_numpy(np.random.default_rng(m + n).uniform(
        -1, 1, (m, n)).astype(np.float32)).to(card)
    launches = bw_probe.READ_LAUNCHES, bw_probe.COPY_LAUNCHES
    s = bw_probe.read_reduce(a, rows_per_cta)
    y = bw_probe.copy(a, rows_per_cta)
    assert (bw_probe.READ_LAUNCHES, bw_probe.COPY_LAUNCHES) == (
        launches[0] + 1, launches[1] + 1)
    # both sum in float64, in other orders: the float32 results differ by
    # at most one rounding
    s0 = bw_probe.read_reduce_reference(a)
    assert _rel(s, s0) <= 1e-7
    assert torch.equal(y, bw_probe.copy_reference(a))


@pytest.mark.parametrize("rows_per_cta", [8, 16, 24, 2048, 4096, 8192])
@pytest.mark.parametrize("m,n", [(1001, 100), ((1 << 14) + 3, 7),
                                 (1 << 15, 128)])
def test_copy_probe_bitwise_at_every_range(card, m, n, rows_per_cta):
    # one contiguous range a CTA: ragged totals end inside a CTA's range
    # and inside a float4
    a = torch.from_numpy(np.random.default_rng(m).uniform(
        -1, 1, (m, n)).astype(np.float32)).to(card)
    assert torch.equal(bw_probe.copy(a, rows_per_cta),
                       bw_probe.copy_reference(a))


def _grad(entry, a, w, v, **kw):
    a = a.detach().clone().requires_grad_()
    q, r = entry(a, **kw)
    assert q.grad_fn is not None and r.grad_fn is not None
    (g,) = torch.autograd.grad((q.float() * w).sum() + (r.float() * v).sum(),
                               a)
    return g


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
@pytest.mark.parametrize("entry", ["tsqr", "qr_auto_fused"])
def test_gradients_on_card_match_cpu(card, entry, mode):
    import tsqr_tpu_torch
    rng = np.random.default_rng(9)
    m, n = 4096, 64
    a, w = (torch.from_numpy(rng.uniform(-1, 1, (m, n)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.uniform(-1, 1, (n, n)).astype(np.float32))
    fn = getattr(tsqr_tpu_torch, entry)
    g_card = _grad(fn, a.to(card), w.to(card), v.to(card), mode=mode)
    g_cpu = _grad(fn, a, w, v, mode=mode, device="cpu")
    # the same rule on factors that agree to float32 grade, through
    # R^{-1} of a well-conditioned A (kappa ~ 5)
    assert _rel(g_card.cpu(), g_cpu) <= 1e-5
    # a CPU tensor given to the card's entry gets its gradient on the CPU
    g_moved = _grad(fn, a, w.to(card), v.to(card), mode=mode)
    assert g_moved.device.type == "cpu"
    assert _rel(g_moved, g_card.cpu()) <= 1e-6


def test_probes_raise_on_what_they_do_not_take(card):
    a = torch.zeros(1 << 10, 128, device=card)
    with pytest.raises(ValueError, match="multiple of 8"):
        bw_probe.read_reduce(a[:1001])
    with pytest.raises(ValueError, match="aligned"):
        bw_probe.copy(a.view(-1)[1:1 + 64 * 128].view(64, 128))
    with pytest.raises(ValueError, match="rows_per_cta"):
        bw_probe.copy(a, rows_per_cta=12)
