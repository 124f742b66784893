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
from tsqr_tpu_torch.ops import bw_probe, gram_stream, panel_kernel, split_mm
from tsqr_tpu_torch.utils import latms, trace, validation

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
    launches = trace.counts("launches.")["stream_gram"]
    q, p = gram_stream.stream(a, *dots, **kw)
    assert trace.counts("launches.")["stream_gram"] == launches + 1
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
    # past the wide kernels' range, in every mode (n = 256 runs them)
    for mode in ("fp32", "bf16x6_cor"):
        with pytest.raises(ValueError, match="n <="):
            gram_stream.stream(torch.zeros(2100, 2056, device=card),
                               gram_mode=mode)
    with pytest.raises(ValueError, match="at most 3"):
        gram_stream.stream(a, (rinv,) * 4, ("fp32",) * 4, write_q=True)


# the wide kernels (128 < n <= 2048, every mode): shapes over one and
# several row chunks (gram_stream.WIDE_CHUNK_ROWS slabs; 6144 rows a chunk
# at n = 1024), and the widest n
WIDE_SHAPES = ((1001, 200), (7001, 1024), (40000, 256), (3001, 2048))
WIDE_TOL = {"fp32": 1e-6, "bf16x6_cor": 1e-6, "bf16x3_cor": 1e-5,
            "bf16": 4e-3}


def _wide_sites(mode, rinv, delta):
    """Each call kind of the wide pass: (rinvs, dot modes, residual,
    write_q, Gram)."""
    return {
        "gram_only": ((), (), (), False, True),
        "qpass": ((rinv,), (mode,), (), True, False),
        "dot_gram": ((rinv,), (mode,), (), False, True),
        "qpass_gram": ((rinv,), (mode,), (), True, True),
        "residual": ((rinv, delta), (mode, "bf16x3_cor"), (False, True),
                     True, True),
        "chain3": ((rinv, delta, delta), (mode,) * 3, (False, True, True),
                   True, False),
    }


@pytest.mark.parametrize("m,n", WIDE_SHAPES)
@pytest.mark.parametrize("mode", list(WIDE_TOL))
def test_wide_kernels_match_plain_version(card, mode, m, n):
    a, rinv, delta = _inputs(card, m, n, seed=n)
    io = torch.bfloat16 if mode == "bf16" else torch.float32
    a = a.to(io)
    for site, (rs, dm, res, wq, gram) in _wide_sites(mode, rinv,
                                                     delta).items():
        kw = dict(residual=res, write_q=wq, gram_mode=mode if gram else None,
                  out_dtype=io)
        got = gram_stream.stream(a, rs, dm, **kw)
        ref = gram_stream.stream_reference(a, rs, dm, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if wq:
            assert got[0].dtype == io and got[0].shape == (m, n)
            assert _rel(got[0], ref[0]) <= WIDE_TOL[mode], (site, "q")
        if gram:
            p, p0 = got[-1], ref[-1]
            assert _rel(p + p.T, p0 + p0.T) <= WIDE_TOL[mode], (site, "g")


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp32", "bf16x3_cor", "bf16x6_cor"])
def test_wide_kernels_at_an_odd_width(card, mode, io):
    """n = 201: rows not 16-byte aligned (4-byte copies, scalar loads in
    the split), a ragged last tile of every kind; A in float32 and bf16."""
    m, n = 3001, 201
    a, rinv, delta = _inputs(card, m, n, seed=5)
    a = a.to(io)
    for site, (rs, dm, res, wq, gram) in _wide_sites(mode, rinv,
                                                     delta).items():
        kw = dict(residual=res, write_q=wq, gram_mode=mode if gram else None,
                  out_dtype=torch.float32)
        got = gram_stream.stream(a, rs, dm, **kw)
        ref = gram_stream.stream_reference(a, rs, dm, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if wq:
            assert _rel(got[0], ref[0]) <= WIDE_TOL[mode], (site, "q")
        if gram:
            p, p0 = got[-1], ref[-1]
            assert _rel(p + p.T, p0 + p0.T) <= WIDE_TOL[mode], (site, "g")
    a1 = a.clone()
    q = gram_stream.stream(a1, (rinv,), (mode,), write_q=True, alias_q=True)
    assert torch.equal(q, gram_stream.stream(a, (rinv,), (mode,),
                                             write_q=True))
    assert q.data_ptr() == a1.data_ptr()


@pytest.mark.parametrize("m,n", WIDE_SHAPES)
def test_wide_bitwise_recompute_and_alias_q(card, m, n):
    """A Gram-only and a Q-writing call with the same dots give the same
    Gram, Q re-read through an identity fp32 dot gives it again, and
    alias_q writes the same Q over A, for one dot and two."""
    a, rinv, delta = _inputs(card, m, n, seed=7)
    eye = torch.eye(n, device=card)
    for dots, res in ((((rinv, delta), ("bf16x6_cor", "bf16x3_cor")),
                       (False, True)),
                      (((rinv,), ("bf16x6_cor",)), (False,))):
        p_gram = gram_stream.stream(a, *dots, residual=res,
                                    gram_mode="bf16x6_cor")
        q, p_q = gram_stream.stream(a, *dots, residual=res, write_q=True,
                                    gram_mode="bf16x6_cor")
        p_re = gram_stream.stream(q, (eye,), ("fp32",),
                                  gram_mode="bf16x6_cor")
        assert torch.equal(p_gram, p_q) and torch.equal(p_re, p_q)
        for gram in (None, "bf16x6_cor"):
            kw = dict(residual=res, write_q=True, gram_mode=gram)
            ref = gram_stream.stream(a, *dots, **kw)
            a1 = a.clone()
            got = gram_stream.stream(a1, *dots, alias_q=True, **kw)
            ref, got = (ref, got) if gram else ((ref,), (got,))
            assert got[0].data_ptr() == a1.data_ptr()
            assert all(torch.equal(x, y) for x, y in zip(got, ref))
    ab = a.bfloat16()
    ref = gram_stream.stream(ab, (rinv,), ("bf16",), write_q=True,
                             gram_mode="bf16")
    a1 = ab.clone()
    got = gram_stream.stream(a1, (rinv,), ("bf16",), write_q=True,
                             gram_mode="bf16", alias_q=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(a1, ref[0])


def test_wide_launch_counters(card):
    """Each wide kernel adds one a launch: a dot a chunk, a Gram a chunk,
    the reduction once a call; the n <= 128 kernel none."""
    m, n = 7001, 1024
    a, rinv, delta = _inputs(card, m, n)
    chunks = -(-m // gram_stream._wide_lib().stream_wide_chunk_rows(n))
    assert chunks >= 2

    def counts():
        c = trace.counts("launches.")
        return tuple(c[k] for k in (
            "stream_wide_dot", "stream_wide_gram", "stream_wide_dot_fp32",
            "stream_wide_gram_fp32", "stream_gram_reduce", "stream_gram",
            "stream_wide_split_r"))

    before = counts()
    gram_stream.stream(a, (rinv, delta), ("bf16x6_cor", "bf16x3_cor"),
                       residual=(False, True), write_q=True,
                       gram_mode="bf16x6_cor")
    after = counts()
    assert tuple(x - y for x, y in zip(after, before)) == (
        2 * chunks, chunks, 0, 0, 1, 0, 1)
    # the fp32 kernels count apart from the split modes'
    gram_stream.stream(a, (rinv, delta), ("fp32", "bf16x3_cor"),
                       residual=(False, True), write_q=True,
                       gram_mode="fp32")
    assert tuple(x - y for x, y in zip(counts(), after)) == (
        chunks, 0, chunks, chunks, 1, 0, 1)


def test_wide_kernels_raise_rather_than_fall_back(card):
    a, rinv, _ = _inputs(card, 1001, 256)
    with pytest.raises(ValueError, match="chunk"):
        gram_stream.stream(a, gram_mode="bf16x6_cor", chunk=1024)
    with pytest.raises(ValueError, match="at most 3"):
        gram_stream.stream(a, (rinv,) * 4, ("fp32",) * 4, write_q=True)
    with pytest.raises(ValueError, match="float32 or bf16"):
        gram_stream.stream(a.double(), gram_mode="fp32")
    launches = trace.counts("launches.")
    with pytest.raises(ValueError, match="n <="):
        gram_stream.stream(torch.zeros(2100, 2050, device=card), (
            torch.eye(2050, device=card),), ("bf16x3_cor",), write_q=True)
    assert trace.counts("launches.") == launches


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
    launches = trace.counts("launches.")["panel_qr"]
    qt, r = panel_kernel.panel_qr_batched(a, mode)
    assert trace.counts("launches.")["panel_qr"] == launches + 1
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
    outer = trace.counts("panel_wide.")["outer_applies"]
    qt, r = panel_kernel.panel_qr_batched(a, "bf16x6_cor")
    # n = 128 is panel_qr.cu's: no 64-column apply
    assert trace.counts("panel_wide.")["outer_applies"] == outer
    qt0, r0 = panel_kernel.panel_qr_reference(a, "bf16x6_cor")
    assert _rel(r, r0) <= 1e-5 and _rel(qt, qt0) <= 1e-5


def test_panel_kernel_raises_on_what_it_does_not_take(card):
    # past the wide kernel's width and height (n = 160 is taken now)
    with pytest.raises(ValueError, match="n <="):
        panel_kernel.panel_qr_batched(
            _tiles(card, 2, 1024, panel_kernel.WIDE_N_MAX + 8), "fp32")
    with pytest.raises(ValueError, match="L <="):
        panel_kernel.panel_qr_batched(
            _tiles(card, 2, panel_kernel.L_WIDE_MAX + 8, 160), "fp32")
    too_tall = panel_kernel.max_leaf_rows(128) + 8
    with pytest.raises(ValueError, match="holds L <="):
        panel_kernel.panel_qr_batched(_tiles(card, 2, too_tall, 128), "fp32")
    with pytest.raises(ValueError, match="in-kernel mode"):
        panel_kernel.panel_qr_batched(_tiles(card, 2, 256, 128),
                                      "bf16x3_cor_emu")


# ---- panel_qr.cu's cluster path: a tile over 2, 4 or 8 CTAs ---------------

def _cluster_run(a, mode, k):
    md = gram_stream._mode(mode)
    launches = trace.counts("launches.")["panel_qr"]
    clusters = trace.counts("panel_qr.")["cluster_launches"]
    qt, r, got = panel_kernel._panel_kernel(a, md, k)
    assert got == k
    assert trace.counts("launches.")["panel_qr"] == launches + 1
    assert (trace.counts("panel_qr.")["cluster_launches"]
            == clusters + (k > 1))
    return qt, r


@pytest.mark.parametrize("mode", list(PANEL_MODES))
@pytest.mark.parametrize("rows", ["n", "2n", "256", "max"])
@pytest.mark.parametrize("n", [16, 50, 64, 100, 128])
def test_cluster_path_is_the_one_cta_kernel_bit_for_bit(card, n, rows,
                                                        mode):
    """Each tile over k = 2, 4, 8 CTAs (as many as its 16-column blocks
    allow, and its shared memory holds) gives the outputs of one CTA a
    tile bit for bit: every column sees the same operations in the same
    order.  With a zero column and zero rows below every pivot, at batch
    1 and 5; n = 100 gives the CTAs of a cluster unequal shares (7
    blocks)."""
    L = {"n": n, "2n": 2 * n, "256": 256,
         "max": panel_kernel.max_leaf_rows(n)}[rows]
    for batch in (1, 5):
        a = _tiles(card, batch, L, n, seed=3 * n + L + batch)
        a[:, :, n // 3] = 0.0         # a zero column: H = I
        if L > n + 8:
            a[:, L - 8:, :] = 0.0     # zero rows: zero Q rows
        qt1, r1 = _cluster_run(a, mode, 1)
        qt0, r0 = panel_kernel.panel_qr_reference(a, mode)
        tol = PANEL_MODES[mode]
        assert _rel(r1, r0) <= tol and _rel(qt1, qt0) <= tol
        for k in panel_kernel.CLUSTER_SIZES:
            if (k > -(-n // panel_kernel.BLOCK)
                    or panel_kernel.cluster_smem_bytes(L, n, k) > 232448):
                with pytest.raises(RuntimeError, match="cluster"):
                    _cluster_run(a, mode, k)
                continue
            qt, r = _cluster_run(a, mode, k)
            assert torch.equal(qt, qt1) and torch.equal(r, r1), (k, batch)
            if L > n + 8:
                assert bool((qt[:, :, L - 8:] == 0).all())


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor", "bf16"])
@pytest.mark.parametrize("L,n", [(256, 128), (288, 128), (512, 64),
                                 (100, 50)])
def test_cluster_path_at_the_largest_batch_each_k_takes(card, L, n, mode):
    """The most clusters of k the card runs at once (the occupancy query
    ``cluster_size`` reads), each k against one CTA a tile, bit for bit;
    ``cluster_size`` takes that batch at k and one more past it below k."""
    code = gram_stream._kernel_code(gram_stream._mode(mode))
    for k in panel_kernel.CLUSTER_SIZES:
        if k > -(-n // panel_kernel.BLOCK):
            continue
        most = panel_kernel._max_clusters(code, k, L, n)
        assert most >= 132 // k // 2, (k, most)  # at least half the card
        assert panel_kernel._launch_cluster_size(most, L, n, code) >= k
        assert panel_kernel._launch_cluster_size(most + 1, L, n, code) < k
        a = _tiles(card, most, L, n, seed=k + L)
        qt1, r1 = _cluster_run(a, mode, 1)
        qt, r = _cluster_run(a, mode, k)
        assert torch.equal(qt, qt1) and torch.equal(r, r1), k


def test_tree_levels_take_the_cluster_path(card, monkeypatch):
    """block8192.well's tree, (2^15, 128) at bf16x6_cor: 128 leaves of 256
    rows in one launch of a CTA a tile, then seven levels of 64 ... 1
    (256, 128) nodes on clusters; Q and R those of the tree with a CTA a
    tile everywhere, bit for bit."""
    from tsqr_tpu_torch.core import tsqr
    a = _tiles(card, 1, 1 << 15, N, seed=15)[0]
    launches = trace.counts("launches.")["panel_qr"]
    clusters = trace.counts("panel_qr.")["cluster_launches"]
    with trace.collect() as col:
        q, r = tsqr.tsqr(a, "bf16x6_cor")
    assert trace.counts("launches.")["panel_qr"] == launches + 8
    assert trace.counts("panel_qr.")["cluster_launches"] == clusters + 7
    ks = [(sp.attrs["batch"], sp.attrs["cluster"]) for sp in col.spans
          if sp.name == "panel"]
    assert [b for b, _ in ks] == [128, 64, 32, 16, 8, 4, 2, 1]
    assert ks[0][1] == 1 and all(k >= 2 for _, k in ks[1:]), ks
    monkeypatch.setattr(panel_kernel, "_launch_cluster_size",
                        lambda *args: 1)
    q1, r1 = tsqr.tsqr(a, "bf16x6_cor")
    assert trace.counts("panel_qr.")["cluster_launches"] == clusters + 7
    assert torch.equal(q, q1) and torch.equal(r, r1)
    assert validation.orthogonality_accurate(q) < 1e-5
    assert validation.residual_accurate(a, q, r) < 1e-5


def test_tier4_call_counts_its_cluster_launches(card):
    """tall128.rankdef's call, a (2^20, 128) input with a zero column at
    tier 4: two trees of a leaf launch and 12 levels, the levels of 64 ...
    1 nodes (seven a tree) on clusters."""
    gen = torch.Generator(card).manual_seed(16)
    a = torch.empty(1 << 20, N, device=card).uniform_(-1, 1, generator=gen)
    a[:, 33] = 0.0
    launches = trace.counts("launches.")["panel_qr"]
    clusters = trace.counts("panel_qr.")["cluster_launches"]
    q, r, info = auto.qr_auto_fused(a, "bf16x6_cor", return_info=True)
    assert info["tier"] == 4
    assert trace.counts("launches.")["panel_qr"] == launches + 26
    assert trace.counts("panel_qr.")["cluster_launches"] == clusters + 14
    assert validation.orthogonality_accurate(q) < 1e-5
    assert validation.residual_accurate(a, q, r) < 1e-5


WIDE_PANEL_NS = (136, 200, 256, 384, 512)  # the last panel 8 wide at 136, 200


def _canonical(qt, r):
    """Q^T and R with diag(R) >= 0 (each row of R and of Q^T times its
    diagonal entry's sign, +1 for a zero).  A pivot within a mode's
    rounding of 0 takes either sign in two summation orders, each the
    convention's: at one bf16 part some of the wide tiles' ~n pivots do,
    and a flipped column of Q alone moves Q by 2 / sqrt(B n)."""
    s = torch.where(torch.diagonal(r, dim1=-2, dim2=-1) < 0, -1.0, 1.0)
    return qt * s[..., :, None], r * s[..., :, None]


@pytest.mark.parametrize("mode", list(PANEL_MODES))
@pytest.mark.parametrize("rows", ["n", "2n", "max"])
@pytest.mark.parametrize("n", WIDE_PANEL_NS)
def test_wide_panel_kernel_shapes_and_modes(card, n, rows, mode):
    L = {"n": n, "2n": min(2 * n, panel_kernel.L_WIDE_MAX),
         "max": panel_kernel.L_WIDE_MAX}[rows]
    a = _tiles(card, 3, L, n, seed=n + L)
    launches = trace.counts("launches.")
    outer = trace.counts("panel_wide.")["outer_applies"]
    qt, r = panel_kernel.panel_qr_batched(a, mode)
    assert trace.counts("launches.") - launches == {"panel_qr_wide": 1}
    # the 64-column applies: a trailing update a panel but the last, and
    # the Q build's, a panel each
    assert (trace.counts("panel_wide.")["outer_applies"] - outer
            == panel_kernel.wide_outer_applies(n) == 2 * -(-n // 64) - 1)
    qt0, r0 = panel_kernel.panel_qr_reference(a, mode)
    tol = PANEL_MODES[mode]
    (cq, cr), (cq0, cr0) = _canonical(qt, r), _canonical(qt0, r0)
    assert _rel(cr, cr0) <= tol and _rel(cq, cq0) <= tol
    assert torch.equal(torch.tril(r, -1), torch.zeros_like(r))
    for t in range(a.shape[0]):
        q = qt[t].T
        assert validation.orthogonality_accurate(q) < tol
        assert validation.residual_accurate(a[t], q, r[t]) < tol


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor", "bf16"])
@pytest.mark.parametrize("L,n", [(300, 136), (1000, 500), (700, 256)])
def test_wide_panel_kernel_zero_column_and_zero_rows(card, mode, L, n):
    # L not a multiple of 16: the kernel's padded rows, cut on the way out
    a = _tiles(card, 5, L, n, seed=L)
    a[:, :, n - 9] = 0.0       # a zero column passes as H = I
    a[:, L - 37:, :] = 0.0     # zero rows give exactly zero Q rows
    qt, r = panel_kernel.panel_qr_batched(a, mode)
    assert qt.shape == (5, n, L)
    assert bool((qt[:, :, L - 37:] == 0).all())
    assert bool((r[:, n - 9, n - 9] == 0).all())
    assert bool(torch.isfinite(qt).all() and torch.isfinite(r).all())
    tol = PANEL_MODES[mode]
    qt0, r0 = panel_kernel.panel_qr_reference(a, mode)
    (cq, cr), (cq0, cr0) = _canonical(qt, r), _canonical(qt0, r0)
    assert _rel(cr, cr0) <= tol and _rel(cq, cq0) <= tol
    for t in range(a.shape[0]):
        assert validation.residual_accurate(a[t], qt[t].T, r[t]) < tol


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
def test_tsqr_on_the_wide_leaf_matches_cpu(card, mode):
    import tsqr_tpu_torch
    a = torch.from_numpy(np.random.default_rng(12).uniform(
        -1, 1, (1 << 16, 256)).astype(np.float32))
    launches = trace.counts("launches.")["panel_qr_wide"]
    q, r = tsqr_tpu_torch.tsqr(a.to(card), mode)
    # one leaf call (64 leaves of 1024 rows), then one a level of inner
    # nodes at fan-in 4, (1024, 256) nodes: 16, 4, 1
    assert trace.counts("launches.")["panel_qr_wide"] == launches + 4
    q0, r0 = tsqr_tpu_torch.tsqr(a, mode, device="cpu")
    # the same tree on the same leaves, the kernel against its plain
    # version: float32 grade
    assert _rel(r.cpu(), r0) <= 1e-5 and _rel(q.cpu(), q0) <= 1e-5
    assert validation.orthogonality_accurate(q) < 1e-5
    assert validation.residual_accurate(a.to(card), q, r) < 1e-5


def test_tall256_call_on_card_passes_the_cell_limits(card):
    """The benchmark's tall256 call, ``tsqr(a, "bf16x6_cor")`` with every
    other argument at its default, at (2^16, 256): the plain float64
    reference (``qrbench/reference.py``) judges it within the cell's
    limits; the leaves and each level are one wide launch, each a
    ``panel`` span."""
    import json
    from pathlib import Path

    import tsqr_tpu_torch
    from qrbench import reference
    limits = json.loads((Path(__file__).resolve().parents[1] / "qrbench"
                         / "limits" / "tall256.well.json").read_text())
    gen = torch.Generator(card)
    gen.manual_seed(17)
    a = torch.empty(1 << 16, 256, device=card).uniform_(-1, 1,
                                                        generator=gen)
    launches = trace.counts("launches.")["panel_qr_wide"]
    outer = trace.counts("panel_wide.")["outer_applies"]
    with trace.collect() as col:
        q, r = tsqr_tpu_torch.tsqr(a, "bf16x6_cor")
    levels = [s.attrs["batch"] for s in col.spans if s.name == "tsqr.level"]
    panels = [s.attrs for s in col.spans if s.name == "panel"]
    assert levels == [16, 4, 1]
    assert trace.counts("launches.")["panel_qr_wide"] - launches \
        == 1 + len(levels) == len(panels)
    assert panels == [{"kernel": "panel_wide", "batch": b, "L": 1024,
                       "n": 256, "cluster": 1} for b in [64] + levels]
    # 3 trailing updates and 4 Q-build panels a wide call at n = 256
    assert (trace.counts("panel_wide.")["outer_applies"] - outer
            == 7 * len(panels))
    got = reference.judge(a, q, r)
    assert all(got[k] <= limits[k] for k in limits), (got, limits)


def test_block8192_call_on_card_passes_the_cell_limits(card):
    """The benchmark's block8192 call, ``qr(a, "bf16x6_cor",
    reorth=True)`` at the cell's (2^15, 2^13) on the cell's sm_90 card: 64
    panel steps and 252 projection products, and Q and R within the cell's
    limits against the plain float64 reference."""
    import json
    from pathlib import Path

    import tsqr_tpu_torch
    from qrbench import reference
    if torch.cuda.get_device_capability(card) < (9, 0):
        pytest.skip("needs an sm_90 card, the cell's H100")
    limits = json.loads((Path(__file__).resolve().parents[1] / "qrbench"
                         / "limits" / "block8192.well.json").read_text())
    gen = torch.Generator(card).manual_seed(23)
    a = torch.empty(1 << 15, 1 << 13, device=card).uniform_(-1, 1,
                                                            generator=gen)
    before = trace.counts("blockqr.")
    launches = trace.counts("launches.")
    clusters = trace.counts("panel_qr.")["cluster_launches"]
    q, r = tsqr_tpu_torch.qr(a, "bf16x6_cor", reorth=True)
    assert trace.counts("blockqr.") - before == {"panels": 64,
                                                 "project": 252}
    # 128 trees of a leaf launch and seven levels, the levels on clusters
    got = trace.counts("launches.") - launches
    assert (got["panel_qr"], got["split_mm"]) == (1024, 896)
    assert trace.counts("panel_qr.")["cluster_launches"] - clusters == 896
    got = reference.judge(a, q, r)
    assert all(got[k] <= limits[k] for k in limits), (got, limits)


# split_mm.cu, the Q build's products: tall256's layer-0 and first-level
# products, tall128.rankdef's layer-0 product, a ragged batch and batch 1
SPLIT_MM_SHAPES = ((4096, 256, 256, 256), (1024, 1024, 256, 256),
                   (4096, 256, 128, 128), (3, 1000, 200, 200),
                   (1, 1024, 256, 256))


def _split_operands(card, B, M, K, N, xt, ct, seed=21):
    """x (B, M, K) and c (B, K, N), each contiguous or the transposed view
    of its transpose (the tree's Q^T views and its root block)."""
    gen = torch.Generator(card).manual_seed(seed)

    def draw(rows, cols, t):
        shape = (B, cols, rows) if t else (B, rows, cols)
        v = torch.rand(*shape, device=card, generator=gen) * 2 - 1
        return v.transpose(1, 2) if t else v
    return draw(M, K, xt), draw(K, N, ct)


@pytest.mark.parametrize("xt,ct", [(False, False), (True, False),
                                   (True, True), (False, True)])
@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("B,M,K,N", SPLIT_MM_SHAPES)
def test_split_mm_matches_plain_version(card, B, M, K, N, parts, xt, ct):
    x, c = _split_operands(card, B, M, K, N, xt, ct)
    launches = trace.counts("launches.")["split_mm"]
    y = split_mm.batched_split_mm(x, c, parts)
    assert trace.counts("launches.")["split_mm"] == launches + 1
    y0 = split_mm.split_mm_reference(x, c, parts)
    assert y.shape == y0.shape == (B, M, N) and y.is_contiguous()
    # the same exact products of bf16 parts summed in another order: each
    # sum lies within K u sum |x c| of the exact one (2 u a term for the
    # tensor core's truncating adds), so the two within 4 K u (|x| @ |c|)
    bound = 4 * K * 2.0 ** -24 * (x.double().abs() @ c.double().abs())
    assert bool(((y.double() - y0.double()).abs() <= bound).all())
    del y0, bound
    # against the float64 product, the limit that a launch a part short
    # (the plain version at parts - 1) fails
    limit = split_mm.ERROR_LIMIT[parts]
    error = split_mm.split_mm_error(y, x, c)
    short = split_mm.split_mm_error(split_mm.split_mm_control(x, c, parts),
                                    x, c)
    assert error <= limit < short, (error, limit, short)


def test_split_mm_raises_before_launching(card):
    x = torch.rand(2, 64, 32, device=card)
    c = torch.rand(2, 32, 16, device=card)
    launches = trace.counts("launches.")["split_mm"]
    for args, match in (((x.double(), c, 3), "float32"),
                        ((x, c.bfloat16(), 3), "float32"),
                        ((x.cpu(), c, 3), "cuda device"),
                        ((x, c.cpu(), 3), "cuda device"),
                        ((x, c[:1], 3), "do not match"),
                        ((x, c[:, :16], 3), "do not match"),
                        ((x[0], c[0], 3), "B, M, K"),
                        ((x, c, 0), "parts"),
                        ((x[:, ::2, ::2], c[:, :16], 3), "contiguous")):
        with pytest.raises(ValueError, match=match):
            split_mm.batched_split_mm(*args)
    torch.cuda.synchronize()
    assert trace.counts("launches.")["split_mm"] == launches


def test_tall256_tree_builds_q_on_split_mm(card):
    """``tsqr(a, "bf16x6_cor")`` at the cell's (2^20, 256): its six Q-build
    products (five levels and the leaves) are six launches, none through
    ``policy.mm``, and Q and R pass the cell's orthogonality and residual
    limits."""
    import json
    from pathlib import Path

    import tsqr_tpu_torch
    limits = json.loads((Path(__file__).resolve().parents[1] / "qrbench"
                         / "limits" / "tall256.well.json").read_text())
    gen = torch.Generator(card).manual_seed(19)
    a = torch.empty(1 << 20, 256, device=card).uniform_(-1, 1,
                                                        generator=gen)
    launches = trace.counts("launches.")["split_mm"]
    routes = trace.counts("tsqr.q_build.")
    q, r = tsqr_tpu_torch.tsqr(a, "bf16x6_cor")
    assert trace.counts("launches.")["split_mm"] == launches + 6
    assert trace.counts("tsqr.q_build.") - routes == {"kernel": 6}
    assert validation.orthogonality_accurate(q) <= limits["orth"]
    assert validation.residual_accurate(a, q, r) <= limits["resid"]


def test_tsqr_gradient_on_the_wide_leaf_matches_cpu(card):
    import tsqr_tpu_torch
    rng = np.random.default_rng(13)
    m, n = 4096, 256
    a, w = (torch.from_numpy(rng.uniform(-1, 1, (m, n)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.uniform(-1, 1, (n, n)).astype(np.float32))
    launches = trace.counts("launches.")["panel_qr_wide"]
    g_card = _grad(tsqr_tpu_torch.tsqr, a.to(card), w.to(card), v.to(card),
                   mode="bf16x6_cor")
    assert trace.counts("launches.")["panel_qr_wide"] > launches
    g_cpu = _grad(tsqr_tpu_torch.tsqr, a, w, v, mode="bf16x6_cor",
                  device="cpu")
    assert _rel(g_card.cpu(), g_cpu) <= 1e-5


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
def test_tsqr_inner_nodes_on_card_match_cpu(card, mode):
    """The inner nodes on the panel kernel against the CPU's route, the
    kernel's plain version, on the same tree: 64 leaves of 128 rows, six
    levels of (256, 128) nodes at fan-in 2, each level's Q and the
    factors at float32 grade."""
    from tsqr_tpu_torch.core import tsqr
    a = torch.from_numpy(np.random.default_rng(14).uniform(
        -1, 1, (8192, N)).astype(np.float32))
    launches = trace.counts("launches.")["panel_qr"]
    inner = trace.counts("tsqr.inner.")
    q, r, levels = tsqr.tsqr(a.to(card), mode, collect_level_q=True)
    assert trace.counts("launches.")["panel_qr"] == launches + 7
    assert trace.counts("tsqr.inner.") - inner == {"kernel": 6}
    q0, r0, levels0 = tsqr.tsqr(a, mode, collect_level_q=True,
                                device="cpu")
    assert [tuple(x.shape) for x in levels] == [
        (64, 128, N)] + [(32 >> k, 256, N) for k in range(6)]
    assert [x.shape for x in levels] == [x.shape for x in levels0]
    for lv, lv0 in zip(levels[1:], levels0[1:]):
        assert _rel(lv.cpu(), lv0) <= 1e-5
    assert _rel(r.cpu(), r0) <= 1e-5 and _rel(q.cpu(), q0) <= 1e-5
    assert validation.orthogonality_accurate(q) < 1e-5
    assert validation.residual_accurate(a.to(card), q, r) < 1e-5


def test_ladder_tiers_on_card(card):
    for kappa, want in ((1, 1), (1e3, 2), (2 ** 18, 3), (0, 4)):
        a_np = (np.random.default_rng(3).uniform(-1, 1, (8192, N)).astype(
            np.float32) if kappa in (0, 1)
            else latms.rand_matrix_with_cond(5, 8192, N, kappa)[0])
        if kappa == 0:
            a_np[:, 33] = 0.0  # a zero column defeats every Gram tier
        a = torch.from_numpy(a_np).to(card)
        launches = trace.counts("launches.")["panel_qr"]
        inner = trace.counts("tsqr.inner.")
        q, r, info = auto.qr_auto_fused(a, "bf16x6_cor", return_info=True)
        assert info["tier"] == want
        if want == 4:
            # two trees (CGS2), each one leaf launch (64 leaves of 128
            # rows) and one a level of (256, 128) inner nodes at fan-in 2:
            # 32, 16, 8, 4, 2, 1
            assert trace.counts("launches.")["panel_qr"] == launches + 14
            assert trace.counts("tsqr.inner.") - inner == {"kernel": 12}
        assert validation.orthogonality_accurate(q) < 1e-5
        assert validation.residual_accurate(a, q, r) < 1e-5


@pytest.mark.parametrize("rows_per_cta", [8, 4096])
@pytest.mark.parametrize("m,n", [(1 << 16, 128), (1000, 100), (336, 7)])
def test_probes_match_plain_versions(card, m, n, rows_per_cta):
    a = torch.from_numpy(np.random.default_rng(m + n).uniform(
        -1, 1, (m, n)).astype(np.float32)).to(card)
    launches = trace.counts("launches.")
    s = bw_probe.read_reduce(a, rows_per_cta)
    y = bw_probe.copy(a, rows_per_cta)
    assert trace.counts("launches.") - launches == {
        "read_reduce": 1, "read_reduce_sum": 1, "copy": 1}
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


UPDATE_CASES = ("append_rows", "append_cols", "delete_cols", "delete_rows",
                "rank_update")


def _update(name, q, r, extra, mode, device=None):
    from tsqr_tpu_torch.core import update
    b_rows, b_cols, u, v = extra
    if name == "append_rows":
        return update.qr_append_rows(q, r, b_rows, mode, device=device)
    if name == "append_cols":
        return update.qr_append_cols(q, r, b_cols, mode, device=device)
    if name == "delete_cols":
        return update.qr_delete_cols(q, r, (0, 31, 63), mode, device=device)
    if name == "delete_rows":
        return update.qr_delete_rows(q, r, 512, mode, device=device)
    return update.qr_rank_update(q, r, u, v, mode, device=device)


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
@pytest.mark.parametrize("name", UPDATE_CASES)
def test_updates_on_card_match_cpu(card, name, mode):
    from tsqr_tpu_torch.core import blockqr
    rng = np.random.default_rng(11)
    m, n = 4096, 64

    def u(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))

    q, r = blockqr.qr(u(m, n), mode, device="cpu")
    extra = (u(512, n), u(m, 16), u(m, 8), u(n, 8))
    launches = trace.counts("launches.")["panel_qr"]
    q1, r1 = _update(name, q.to(card), r.to(card),
                     [x.to(card) for x in extra], mode)
    assert q1.is_cuda and r1.is_cuda
    # every small core but delete_rows' Cholesky reaches the panel kernel
    launched = trace.counts("launches.")["panel_qr"] > launches
    assert launched == (name != "delete_rows")
    q0, r0 = _update(name, q, r, extra, mode, device="cpu")
    # the same update on the same factors: the card's panel kernel and the
    # CPU's plain version sum in other orders, float32 grade
    assert _rel(r1.cpu(), r0) <= 1e-5 and _rel(q1.cpu(), q0) <= 1e-5


def test_trace_records_cuda_kernels(card, tmp_path):
    from tsqr_tpu_torch.core import blockqr
    from tsqr_tpu_torch.harness import profile
    a = torch.rand(1 << 14, 128, device=card)
    blockqr.qr(a)
    with profile.trace(str(tmp_path)) as tr:
        blockqr.qr(a)
    s = tr.summary()
    assert s["kernels"] > 0 and 0 < s["busy_share"] <= 1
    assert any("panel_qr" in t["name"] for t in tr.summary(top=50)["top"])


def test_ablate_no_panel_launches_no_panel_kernel(card):
    from tsqr_tpu_torch.core import blockqr
    a = torch.rand(1 << 12, 256, device=card)
    launches = trace.counts("launches.")["panel_qr"]
    blockqr.qr(a, _ablate="no_panel")
    torch.cuda.synchronize()
    assert trace.counts("launches.")["panel_qr"] == launches
    blockqr.qr(a, _ablate="no_project")
    # two 128-wide panels, each a tree of one leaf launch (16 leaves of
    # 256 rows, tsqr.tree_plan) and four levels of inner nodes
    assert trace.counts("launches.")["panel_qr"] == launches + 10


# ---- core/ooc.py and models/ on the card against the CPU ------------------

def _u(rng, *shape):
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("mode,method", [("fp32", "cholqr3"),
                                         ("bf16x6_cor", "cholqr2"),
                                         ("bf16", "cholqr1")])
def test_qr_out_of_core_on_card_matches_cpu(card, mode, method):
    from tsqr_tpu_torch.core import ooc
    a = _u(np.random.default_rng(12), 5000, 64)
    if mode == "bf16":
        a = a.to(torch.bfloat16)
    q1, r1, info1 = ooc.qr_out_of_core(a, mode, method, chunk_rows=1024,
                                       metrics=True)
    q0, r0, info0 = ooc.qr_out_of_core(a, mode, method, chunk_rows=1024,
                                       metrics=True, device="cpu")
    tol = auto._TOL[auto.M(mode)]
    assert q1.device.type == "cpu" and q1.dtype == q0.dtype
    assert _rel(q1, q0) <= tol and _rel(r1, r0) <= tol
    assert abs(info1["orthogonality"] - info0["orthogonality"]) <= tol
    assert ooc.ooc_orthogonality(q1, 1024) < (2e-2 if mode == "bf16"
                                              else 1e-5)
    assert abs(ooc.ooc_residual(a, q1, r1, 1024) - ooc.ooc_residual(
        a, q0, r0, 1024, device="cpu")) <= tol


@pytest.mark.parametrize("fault", [3, 10, 17])
def test_qr_out_of_core_checkpoint_resumes_bitwise_on_card(card, tmp_path,
                                                           fault):
    # 4 chunks a pass, cholqr3: steps 1-4, 6-9, 11-14 Gram passes, 5 and
    # 10 chain extensions, 15-18 the Q pass
    from tsqr_tpu_torch.core import ooc
    a = _u(np.random.default_rng(13), 4096, 48).numpy()
    q, r, info = ooc.qr_out_of_core(a, "fp32", "cholqr3", chunk_rows=1024,
                                    metrics=True)
    out = np.empty_like(a)
    ck = tmp_path / "ck.npz"
    with pytest.raises(ooc.OOCInterrupted):
        ooc.qr_out_of_core(a, "fp32", "cholqr3", chunk_rows=1024,
                           metrics=True, out=out, checkpoint=ck,
                           _fault_after=fault)
    q2, r2, info2 = ooc.qr_out_of_core(a, "fp32", "cholqr3", chunk_rows=1024,
                                       metrics=True, out=out, checkpoint=ck)
    assert q2 is out and not ck.exists()
    assert torch.equal(torch.from_numpy(out), q) and torch.equal(r2, r)
    assert info2 == info


def test_qr_regen_and_lstsq_regen_on_card_match_cpu(card):
    import importlib

    from tsqr_tpu_torch.core import ooc
    lstsq_mod = importlib.import_module("tsqr_tpu_torch.models.lstsq")
    rng = np.random.default_rng(14)
    a, b = _u(rng, 4096, 64), _u(rng, 4096)
    a_card = a.to(card)

    def gens(x):
        return lambda i: x[i * 512:(i + 1) * 512]

    for mode, method in (("bf16x6_cor", "cholqr2"), ("fp32", "cholqr3"),
                         ("fp32", "cholqr_iter")):
        r1, i1 = ooc.qr_regen(gens(a_card), 4096, 64, mode, method, 512)
        r0, i0 = ooc.qr_regen(gens(a), 4096, 64, mode, method, 512,
                              device="cpu")
        assert r1.is_cuda and _rel(r1.cpu(), r0) <= 1e-5
        assert float(i1["orthogonality"]) < 1e-5
    x1, j1 = lstsq_mod.lstsq_regen(gens(a_card), b, 4096, 64,
                                   chunk_rows=512)
    x0, j0 = lstsq_mod.lstsq_regen(gens(a), b, 4096, 64, chunk_rows=512,
                                   device="cpu")
    assert _rel(x1.cpu(), x0) <= 1e-5
    assert abs(float(j1["residual"]) - float(j0["residual"])) <= 1e-5
    gen = ooc.uniform_gen(5, 1024, 64, dtype=torch.float32)
    first = [gen(i) for i in range(3)]
    assert first[0].is_cuda
    assert all(torch.equal(gen(i), first[i]) for i in (2, 0, 1))


@pytest.fixture
def same_draws(monkeypatch):
    """The models' draws made by one CPU generator and moved to the call's
    device, so that the card's call and the CPU's see the same random
    matrices."""
    import importlib

    from tsqr_tpu_torch import modes

    def reset():
        g = torch.Generator().manual_seed(0)

        def normal(gen, shape, device):
            return torch.randn(shape, generator=g).to(device)

        def sketch(a, gen, l):
            om = torch.randn(l, a.shape[0], generator=g).to(a.device)
            return modes.mm_fp32(om, a)

        for name in ("rsvd", "lanczos", "lstsq", "subspace"):
            monkeypatch.setattr(importlib.import_module(
                f"tsqr_tpu_torch.models.{name}"), "_normal", normal)
        monkeypatch.setattr(importlib.import_module(
            "tsqr_tpu_torch.models.qrcp"), "_sketch", sketch)

    return reset


def _model_call(name, on, card):
    """One model call on the card (on=card) or the CPU, and what of its
    result is unique (values, products, subspace projectors)."""
    from tsqr_tpu_torch import models as tm
    dev = card if on == card else torch.device("cpu")
    kw = {} if on == card else {"device": "cpu"}
    rng = np.random.default_rng(15)
    a = _u(rng, 2048, 32)
    low = (_u(rng, 2048, 6) @ _u(rng, 6, 32))
    d = torch.linspace(1.0, 0.01, 2048)
    d[:8] = torch.tensor([10., 9., 8., 7., 6., 5., 4., 3.])
    d = d.to(dev)
    g = torch.Generator(device=dev)

    def mv(x):
        return d[:, None] * x

    def proj(u):
        u = torch.linalg.qr(u.double()).Q
        return u @ u.T

    if name == "tsqr_svd":
        u, s, vt = tm.tsqr_svd(a.to(dev), "bf16x6_cor", "cholqr3_fused", **kw)
        return [s, (u * s) @ vt]
    if name == "rsvd":
        u, s, vt = tm.rsvd(low.to(dev), 6, g, **kw)
        return [s, (u * s) @ vt]
    if name == "block_lanczos":
        qb, _, _ = tm.block_lanczos(mv, 2048, 8, 4, g, **kw)
        return [torch.linalg.eigvalsh(qb.T @ (d[:, None] * qb))]
    if name == "lstsq":
        return [tm.lstsq(a.to(dev), a[:, 0].to(dev) + 0.1, ridge=r, **kw)
                for r in (0.0, 0.5)]
    if name == "lstsq_cgls":
        ad = a.to(dev)
        x, _ = tm.lstsq_cgls(lambda v: ad @ v, lambda v: ad.T @ v,
                             a[:, 0].to(dev) + 0.1, 32, gen=g, tol=1e-6, **kw)
        return [x]
    if name == "pivoted_qr":
        q, r, piv, db = tm.pivoted_qr(low.to(dev), g, **kw)
        # past the rank the pivots are the noise's: compare the rank's
        # pivots and the truncation in the original column order
        rec = torch.empty_like(q)
        rec[:, piv] = q[:, :6] @ r[:6]
        return [piv[:6].float(), db, rec]
    if name == "interpolative":
        cols, coeff, _ = tm.interpolative(low.to(dev), g, 6, **kw)
        return [cols.float(), low.to(dev)[:, cols] @ coeff]
    if name == "cur":
        cols, u, rows = tm.cur(low.to(dev), g, 6, **kw)
        ld = low.to(dev)
        return [cols.float(), rows.float(), ld[:, cols] @ u @ ld[rows]]
    if name == "polar":
        u, h = tm.polar(a.to(dev), "bf16x6_cor", **kw)
        return [u @ h, h]
    if name == "procrustes":
        return [tm.procrustes(a.to(dev), a.to(dev) @ torch.linalg.qr(
            _u(rng, 32, 32)).Q.to(dev), **kw)]
    if name == "subspace_iteration":
        w, v = tm.subspace_iteration(mv, 2048, 6, g, **kw)
        return [w, proj(v)]
    if name == "nystrom":
        u, lam = tm.nystrom(mv, 2048, 6, g, **kw)
        return [lam, proj(u)]
    corrs = [tm.cca(a[:, :16].to(dev), a[:, 16:].to(dev) + 0.5 * a[:, :16]
                    .to(dev), method=m, **kw)[0]
             for m in ("tsqr", "auto", "cholqr2")]
    return corrs


MODELS = ("tsqr_svd", "rsvd", "block_lanczos", "lstsq", "lstsq_cgls",
          "pivoted_qr", "interpolative", "cur", "polar", "procrustes",
          "subspace_iteration", "nystrom", "cca")


@pytest.mark.parametrize("name", MODELS)
def test_models_on_card_match_cpu(card, same_draws, name):
    same_draws()
    got = _model_call(name, card, card)
    same_draws()
    want = _model_call(name, "cpu", card)
    for x, y in zip(got, want):
        assert x.is_cuda
        # lstsq_cgls: its iterates agree to the solve's own accuracy
        tol = 1e-3 if name == "lstsq_cgls" else 1e-5
        assert _rel(x.cpu(), y) <= tol, name


def test_precision_harness_on_card(card):
    from tsqr_tpu_torch.harness import precision
    out = precision.run(m=1 << 14, chunk=1 << 13)
    svd = out["small_svd_128"]
    assert set(svd) >= {"float32 default", "float64 gesvd"}
    # the float64 SVD rounded to float32 is what models._common.svd runs
    assert svd["float64 gesvd"]["u_orthogonality"] < 1e-6
    grams = out[f"gram_rel_err_{1 << 14}x128"]
    assert all(v["blocks"] < 1e-4 for k, v in grams.items()
               if isinstance(v, dict))
    assert out[f"regen_q_orthogonality_{1 << 14}x128"]["fp32"] < 1e-5


def test_native_emulation_matches_card_modes(card):
    from tsqr_tpu_torch import modes
    from tsqr_tpu_torch.utils import native

    rng = np.random.default_rng(0)
    xs = rng.uniform(-4, 4, 256).astype(np.float32)
    for bits in (7, 10):
        on_card = modes.clip_mantissa(torch.from_numpy(xs).to(card), bits)
        cx = np.array([native.clip_mantissa_scalar(float(x), bits)
                       for x in xs], np.float32)
        np.testing.assert_array_equal(on_card.cpu().numpy(), cx)
    a = rng.uniform(-1, 1, (32, 48)).astype(np.float32)
    b = rng.uniform(-1, 1, (48, 24)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    for emu, fn, tol in ((native.emu_gemm_nocor, modes.mm_bf16_nocor_emu,
                          1e-4),
                         (native.emu_gemm_cor, modes.mm_bf16x3_cor_emu, 1e-5),
                         (native.emu_gemm_mixed, modes.mm_mixed_cor_emu,
                          1e-5)):
        got = fn(ta, tb).cpu().numpy()
        assert np.max(np.abs(emu(a, b, bits=7) - got)) < tol, emu.__name__


def test_distributed_drivers_on_card(card):
    import _torch_parallel_ranks as ranks
    from tsqr_tpu_torch.core import tsqr
    from tsqr_tpu_torch.ops import _build
    from tsqr_tpu_torch.parallel import launch

    _build.build(("panel_qr",))     # once, before the ranks load it
    a = np.random.default_rng(5).uniform(-1, 1, (1 << 16, N)).astype(
        np.float32)
    out = launch.spawn(2, ranks.card_cases, (a,), device="cuda",
                       timeout=300)
    r_one = tsqr.tsqr(torch.from_numpy(a).to(card), "fp32")[1].double()
    sign = torch.sign(torch.diagonal(r_one)).cpu().numpy()
    for name in out[0]:
        rs = [o[name] for o in out]
        resid, orth = rs[0]["metrics"]
        assert resid < 1e-5 and orth < 1e-5, (name, resid, orth)
        r = rs[0]["r"]
        r = r * (np.sign(np.diag(r)) * sign)[:, None]
        assert _rel(torch.from_numpy(r), r_one.cpu()) < 1e-5, name
        if name in ("allgather", "butterfly"):
            assert all(np.array_equal(x["r"], rs[0]["r"]) for x in rs)
            assert all(x["panel_launches"] > 0 for x in rs)
