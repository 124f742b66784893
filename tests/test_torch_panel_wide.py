"""The wide panel kernel's range (128 < n <= 512) on the CPU: its plain
version against the JAX package's blocked Householder (the same
function, one panel a call), ``tsqr`` on it against the JAX package's
``tsqr``, and the wrapper's range rules and shape checks, on the same
numpy inputs.  The kernel itself runs on the card
(``tests/test_torch_gpu.py``, ``-k wide``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu import modes as jmodes
from tsqr_tpu.core import tsqr as jtsqr
from tsqr_tpu.ops import householder as jhouseholder
from tsqr_tpu_torch.core import auto
from tsqr_tpu_torch.core import tsqr as tsqr_mod
from tsqr_tpu_torch.ops import householder, panel_kernel
from tsqr_tpu_torch.utils import trace, validation


def _rel(x, ref) -> float:
    x = x.detach().double().numpy() if isinstance(x, torch.Tensor) else x
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _uniform(seed, *shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
@pytest.mark.parametrize("b,L,n", [(3, 288, 136), (2, 512, 256)])
def test_wide_tiles_match_jax_blocked_householder(b, L, n, mode):
    a = _uniform(n, b, L, n)
    qt, r = panel_kernel.panel_qr_batched(torch.from_numpy(a), mode)
    fn = functools.partial(jhouseholder.blocked_householder_qr,
                           mm=jmodes.resolve(mode).mm,
                           block=panel_kernel.BLOCK)
    qj, rj = jax.jit(jax.vmap(fn))(jnp.asarray(a))
    assert qt.shape == (b, n, L) and r.shape == (b, n, n)
    # the same reflectors summed in other orders: float32 grade
    assert _rel(r, rj) <= 1e-5
    assert _rel(qt.transpose(1, 2), qj) <= 1e-5
    assert torch.equal(torch.tril(r, -1), torch.zeros_like(r))


def test_wide_zero_column_and_zero_rows():
    a = _uniform(3, 2, 320, 160)
    a[:, :, 140] = 0.0     # a zero column passes as H = I
    a[:, 250:, :] = 0.0    # zero rows give exactly zero Q rows
    for mode in ("fp32", "bf16x6_cor"):
        qt, r = panel_kernel.panel_qr_batched(torch.from_numpy(a), mode)
        assert bool((qt[:, :, 250:] == 0).all())
        assert bool((r[:, 140, 140] == 0).all())
        for t in range(a.shape[0]):
            assert validation.orthogonality(qt[t].T) < 1e-5
            assert validation.residual(a[t], qt[t].T, r[t]) < 1e-5


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor"])
@pytest.mark.parametrize("impl", [None, "pallas", "pallas_sb"])
def test_tsqr_on_the_wide_leaf_matches_jax(impl, mode):
    a = _uniform(11, 4096, 256)
    q, r = tsqr_mod.tsqr(torch.from_numpy(a), mode, impl=impl, device="cpu")
    qj, rj = jtsqr.tsqr(jnp.asarray(a), mode, impl="jnp")
    tol = auto._TOL[auto.M(mode)]
    # the same 8 leaves; the inner nodes reduce at fan-in 4 here (the
    # kernel's node at n = 256) and at 8 there, and R's row signs follow
    # the tree's shape: both factors in canonical signs
    (q, r), (qj, rj) = (householder.qr_sign_normalize(q, r),
                        jhouseholder.qr_sign_normalize(qj, rj))
    assert _rel(r, rj) <= tol and _rel(q, qj) <= tol
    assert validation.orthogonality(q) < tol
    assert validation.residual(a, q, r) < tol


def test_leaf_rule_and_height_past_128():
    for n in (129, 256, 512):
        assert tsqr_mod.leaf_impl(None, n) == "pallas_sb"
        for impl in ("pallas", "pallas_sb", "pallas_interpret"):
            assert tsqr_mod.leaf_impl(impl, n) == impl
        assert (tsqr_mod.default_leaf_rows(n)
                == panel_kernel.leaf_rows(n)
                == panel_kernel.L_WIDE_MAX)
        # the tree's leaves at the default height fit the wide kernel
        for m in (1 << 12, 1 << 18, 1 << 20):
            L = tsqr_mod.plan_tree(m, n, tsqr_mod.default_leaf_rows(n))[1]
            assert n <= L <= panel_kernel.L_WIDE_MAX
    assert tsqr_mod.leaf_impl(None, 513) == "jnp"
    assert tsqr_mod.leaf_impl("pallas_sb", 520) == "jnp"
    assert tsqr_mod.default_leaf_rows(520) == tsqr_mod.DEFAULT_LEAF_ROWS
    assert panel_kernel.leaf_rows(128) == panel_kernel.max_leaf_rows(128)
    assert (panel_kernel.WIDE_N_MAX == tsqr_mod.PANEL_SB_N_MAX == 512
            and panel_kernel.L_WIDE_MAX == 1024)
    with pytest.raises(ValueError, match="n <= 512"):
        panel_kernel.leaf_rows(513)
    # load; a chain a block and an in-panel update a block but each
    # panel's last; a panel's Y and T and its wide update but the last
    # panel's; R; a panel's Y and its Q update a panel
    assert panel_kernel.wide_kernel_launches(256) == 44
    assert panel_kernel.wide_kernel_launches(512) == 88
    assert panel_kernel.wide_kernel_launches(136) == 27


@pytest.mark.parametrize("n,launches,outer", [(136, 27, 5), (200, 38, 7),
                                               (256, 44, 7), (512, 88, 15)])
def test_wide_launch_and_outer_apply_counts(n, launches, outer):
    # the sequence panel_wide_launch walks: the last panel is 8 columns
    # wide at n = 136 and n = 200, and holds one block there
    seq = ["load"]
    panels = range(0, n, panel_kernel.PANEL)
    for p0 in panels:
        p1 = min(p0 + panel_kernel.PANEL, n)
        for c0 in range(p0, p1, panel_kernel.BLOCK):
            seq.append("factor")
            if c0 + panel_kernel.BLOCK < p1:
                seq.append("apply")
        if p1 < n:
            seq += ["panel", "outer"]
    seq.append("r")
    seq += ["panel", "outer"] * len(panels)
    assert len(seq) == panel_kernel.wide_kernel_launches(n) == launches
    assert seq.count("outer") == panel_kernel.wide_outer_applies(n) == outer


def test_wide_wrapper_checks_shapes_before_any_launch():
    # meta tensors: the checks raise before a library is built or a
    # kernel launched
    md = auto.M("fp32")
    launches = trace.counts("launches.")["panel_qr_wide"]
    for shape, what in (((2, 1032, 256), "L <= 1024"),
                        ((2, 1024, 520), "n <= 512")):
        with pytest.raises(ValueError, match=what):
            panel_kernel._panel_kernel(torch.empty(shape, device="meta"), md)
    with pytest.raises(ValueError, match="float32"):
        panel_kernel._panel_kernel(
            torch.empty(2, 512, 256, dtype=torch.float64, device="meta"), md)
    assert trace.counts("launches.")["panel_qr_wide"] == launches
