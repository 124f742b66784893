"""The measurement path of the port on the CPU: the bandwidth probes'
plain versions against numpy, the in-place stream pass, the flop and
byte models against the JAX package's, and the harness's CSV and status
helpers."""

import io

import numpy as np
import pytest
import torch

from tsqr_tpu.harness import flops as jflops
from tsqr_tpu.harness import mfu as jmfu
from tsqr_tpu_torch.harness import flops, mfu
from tsqr_tpu_torch.ops import bw_probe, gram_stream
from tsqr_tpu_torch.utils import status

torch.set_num_threads(2)


def _a(m, n, seed=0):
    return np.random.default_rng(seed + m + n).uniform(
        -1, 1, (m, n)).astype(np.float32)


@pytest.mark.parametrize("m,n", [(4096, 128), (1000, 100), (8, 3)])
def test_probe_plain_versions_match_numpy(m, n):
    a = _a(m, n)
    s = bw_probe.read_reduce(torch.from_numpy(a))
    s_np = a.astype(np.float64).reshape(-1, 8, n).sum(0)
    assert s.dtype == torch.float32 and tuple(s.shape) == (8, n)
    # a float64 sum rounded once: within one float32 rounding of numpy's
    np.testing.assert_allclose(s.numpy(), s_np, rtol=6e-8, atol=0)
    y = bw_probe.copy(torch.from_numpy(a))
    # the JAX probe's x * 1.0000001: one float32 multiply, bit for bit
    assert np.float32(1.0000001) == np.float32(bw_probe.COPY_SCALE)
    assert np.array_equal(y.numpy(), a * np.float32(1.0000001))


def test_probes_raise_on_what_they_do_not_take():
    with pytest.raises(ValueError, match="multiple of 8"):
        bw_probe.read_reduce(torch.zeros(1001, 4))
    with pytest.raises(ValueError, match="float32"):
        bw_probe.copy(torch.zeros(64, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="2-D"):
        bw_probe.copy(torch.zeros(64))


@pytest.mark.parametrize("io_dtype,mode", [(torch.float32, "bf16x6_cor"),
                                           (torch.bfloat16, "bf16")])
def test_alias_q_on_the_cpu(io_dtype, mode):
    a = torch.from_numpy(_a(777, 64)).to(io_dtype)
    rng = np.random.default_rng(1)
    rinv = torch.from_numpy((np.eye(64) + rng.standard_normal((64, 64)) / 32)
                            .astype(np.float32))
    delta = torch.from_numpy((1e-3 * rng.standard_normal((64, 64)))
                             .astype(np.float32))
    kw = dict(residual=(False, True), write_q=True, gram_mode=mode)
    q0, p0 = gram_stream.stream(a, (rinv, delta), (mode, "bf16x3_cor"), **kw)
    a1 = a.clone()
    q1, p1 = gram_stream.stream(a1, (rinv, delta), (mode, "bf16x3_cor"),
                                alias_q=True, **kw)
    assert q1.data_ptr() == a1.data_ptr() and q1.dtype == io_dtype
    assert torch.equal(q1, q0) and torch.equal(a1, q0) and torch.equal(p1, p0)


def test_alias_q_raises_as_jax_does():
    a = torch.zeros(64, 16)
    rinv = torch.eye(16)
    with pytest.raises(ValueError, match="requires write_q"):
        gram_stream.stream(a, (rinv,), ("fp32",), gram_mode="fp32",
                           alias_q=True)
    with pytest.raises(ValueError, match="out_dtype == a.dtype"):
        gram_stream.stream(a, (rinv,), ("fp32",), write_q=True,
                           out_dtype=torch.bfloat16, alias_q=True)
    # a copy would hold Q, not the caller's tensor
    with pytest.raises(ValueError, match="contiguous"):
        gram_stream.stream(torch.zeros(16, 64).T, (rinv,), ("fp32",),
                           write_q=True, alias_q=True)


MODES = ("fp32", "bf16", "bf16_nocor", "bf16x3_nocor", "bf16x3_cor",
         "bf16x6_cor")
FUSED = [("cholqr1_fused", "safe")] + [
    ("cholqr2_fused", v) for v in ("safe", "fast", "fastest", "compact",
                                   "turbo")] + [
    ("cholqr3_fused", v) for v in ("safe", "fast", "fastest", "compact")]


@pytest.mark.parametrize("mode", MODES)
def test_product_models_are_jax_with_the_port_products(mode, monkeypatch):
    # the one difference, named: the products each mode runs.  The JAX
    # package counts MXU passes (fp32 as the TPU's 6-pass HIGHEST, a
    # 3-pass bf16x3_nocor half-Gram); the port runs fp32 as one float32
    # product and that half-Gram as two.  With the port's counts put into
    # the JAX model, the pipelines' tallies agree everywhere.
    agree = mode not in ("fp32", "bf16x3_nocor")
    assert (jflops.DOT_PASSES[mode] == flops.DOT_PRODUCTS[mode]
            and jflops.GRAM_PASSES[mode] == flops.GRAM_PRODUCTS[mode]) == agree
    monkeypatch.setattr(jflops, "DOT_PASSES", dict(flops.DOT_PRODUCTS))
    monkeypatch.setattr(jflops, "GRAM_PASSES", dict(flops.GRAM_PRODUCTS))
    for method, variant in FUSED:
        p = flops.fused_products(mode, method, variant)
        assert p["bf16"] + p["fp32"] == jflops.fused_mxu_passes(
            mode, method, variant), (method, variant)
        # float32 products only in the fp32 mode, never in its Delta pass
        if mode != "fp32":
            assert p["fp32"] == 0
    for method in ("cholqr1", "cholqr2", "cholqr3"):
        p = flops.xla_products(mode, method)
        assert p == {"bf16": 0, "fp32": jflops.xla_mxu_passes(mode, method)}


@pytest.mark.parametrize("mode", MODES)
def test_byte_and_flop_models_equal_jax(mode):
    m, n = 1 << 20, 128
    for method, variant in FUSED:
        assert flops.fused_hbm_bytes(m, n, mode, method, variant) == \
            jflops.fused_hbm_bytes(m, n, mode, method, variant)
    for method in ("cholqr1", "cholqr2", "cholqr3"):
        assert flops.xla_hbm_bytes(m, n, mode, method) == \
            jflops.xla_hbm_bytes(m, n, mode, method)


@pytest.mark.parametrize("m,n,leaf,fanin", [(1 << 20, 128, 2048, 8),
                                            (100_000, 48, 512, 4)])
def test_tree_flop_models_equal_jax(m, n, leaf, fanin):
    assert flops.qr_flops(m, n) == jflops.qr_flops(m, n)
    assert flops.tsqr_flops(m, n, leaf, fanin) == \
        jflops.tsqr_flops(m, n, leaf, fanin)
    for reorth in (False, True):
        assert flops.blockqr_flops(m, 3 * n, n, leaf, fanin, reorth) == \
            jflops.blockqr_flops(m, 3 * n, n, leaf, fanin, reorth)


def test_mfu_csv_and_configs_are_jax():
    assert mfu.CSV_HEADER == jmfu.CSV_HEADER
    assert len(mfu.CONFIGS) == 11
    row = {"m": 1024, "n": 64, "compute_mode": "bf16", "method": "cholqr1",
           "variant": "safe", "elapsed_time": 1e-3, "orthogonality": 2e-3,
           "useful_tflops": 1.0, "useful_mfu": 0.001, "method_tflops": 1.0,
           "method_mfu": 0.015, "hbm_gbps": 3.0, "flag": ""}
    assert len(mfu.format_row(row).split(",")) == \
        len(mfu.CSV_HEADER.split(","))
    # past the JAX package's kernel range at bf16x6_cor (n <= 1024)
    with pytest.raises(mfu.OffFusedRange):
        mfu.mfu_row(2048, 1032, "bf16x6_cor", "cholqr2_fused")


def test_probe_bounds():
    # (2^22, 128) float32 at 3.35 TB/s: 2 GiB read, 4 GiB moved
    r = flops.probe_bound(1 << 22, 128, "read_reduce")
    c = flops.probe_bound(1 << 22, 128, "copy")
    assert r["bound_by"] == c["bound_by"] == "bytes"
    assert abs(r["bound_ms"] - 0.641) < 1e-3
    assert abs(c["bound_ms"] - 1.282) < 1e-3


def test_status_helpers():
    note = status.exc_note(ValueError("a\nb,\tc" + "x" * 300), limit=20)
    assert "\n" not in note and note.startswith("ValueError: a b, c")
    assert len(note) == len("ValueError: ") + 20
    buf = io.StringIO()
    status.print_matrix(torch.arange(40.0).reshape(20, 2), "g", file=buf,
                        max_rows=4)
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("# g (20, 2)") and len(lines) == 6
    assert "truncated" in lines[-1]
    buf = io.StringIO()
    status.print_banner(file=buf)
    assert "torch=" + torch.__version__ in buf.getvalue()
    assert "card=" in buf.getvalue()


@pytest.mark.parametrize("source,define,names", [
    ("stream_gram.cu", "N_PHASES", "PHASE_NAMES"),
    ("panel_qr.cu", "N_PHASES", "PANEL_PHASES"),
])
def test_phase_names_match_the_kernels_timers(source, define, names):
    # harness.phase_profile reads (CTAs, N_PHASES) int64 counters back: its
    # names must be as many as the kernel's phases
    import re
    from pathlib import Path

    from tsqr_tpu_torch.harness import phase_profile

    text = (Path(phase_profile.__file__).parents[1] / "ops" / "csrc"
            / source).read_text()
    n = int(re.search(rf"#define {define} (\d+)", text).group(1))
    assert len(getattr(phase_profile, names)) == n
