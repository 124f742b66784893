"""The port's accuracy harness, validation helpers, timers, exponent study
and phase profiles against the JAX package's, on the same numpy inputs,
all on the CPU.

A row's metrics come from the rounding errors of the QR that produced
them, so the port's and JAX's values on one input are of one grade, not
equal: each per-trial body is held to the mode's grade and to JAX's
value within a factor.  What is exact is held exactly: the CSV headers
and row formats byte for byte, the host float64 metrics on one Q, the
exponent clamps bit for bit, the result keys."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu.core import blockqr as jblockqr
from tsqr_tpu.harness import accuracy as jaccuracy
from tsqr_tpu.harness import baseline as jbaseline
from tsqr_tpu.harness import compare as jcompare
from tsqr_tpu.harness import cond as jcond
from tsqr_tpu.harness import eval_q as jeval_q
from tsqr_tpu.harness import profile as jprofile
from tsqr_tpu.utils import experimental as jexperimental
from tsqr_tpu.utils import validation as jvalidation
from tsqr_tpu_torch.core import blockqr
from tsqr_tpu_torch.harness import (accuracy, baseline, compare, cond,
                                    eval_q, profile)
from tsqr_tpu_torch.utils import (experimental, latms, timing, trace,
                                  validation)


# per-trial metrics of two QR implementations on one input: the same
# grade, within this factor of each other
GRADE_FACTOR = 4.0
GRADE = {"fp32": 1e-6, "bf16x6_cor": 1e-6, "bf16_nocor": 5e-2}


def _rand(m, n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (m, n)).astype(
        np.float32)


def _same_grade(port, ref, grade):
    assert 0 < port < grade and 0 < ref < grade
    assert ref / GRADE_FACTOR <= port <= ref * GRADE_FACTOR


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


SAMPLE = {"m": 4096, "n": 128, "rand_range": 1.0, "type": "float32",
          "compute_mode": "bf16x6_cor", "reorthogonalization": 1,
          "residual": np.float64(3.775896123e-07),
          "residual_variance": np.float64(7.440402e-17),
          "orthogonality": np.float64(2.366226e-07),
          "orthogonality_variance": np.float64(8.933756e-17),
          "condition": 32768.0, "measured_condition": 32771.25,
          "diag": 2.245817e-07, "offdiag": 5.979541e-08}


@pytest.mark.parametrize("port,ref", [(accuracy, jaccuracy), (cond, jcond),
                                      (eval_q, jeval_q)],
                         ids=["accuracy", "cond", "eval_q"])
def test_csv_header_and_rows_are_jaxs_byte_for_byte(port, ref):
    assert port.CSV_HEADER == ref.CSV_HEADER
    assert port.format_row(SAMPLE) == ref.format_row(SAMPLE)


@pytest.mark.parametrize("mode,reorth", [("fp32", False),
                                         ("bf16x6_cor", True),
                                         ("bf16_nocor", False)])
def test_accuracy_trial_matches_jax(mode, reorth):
    a = _rand(512, 48)
    res, orth = accuracy.accuracy_trial(torch.from_numpy(a), mode, reorth,
                                        panel_width=16)
    qj, rj = jblockqr.qr(jnp.asarray(a), mode, reorth=reorth,
                         panel_width=16)
    _same_grade(res, jvalidation.residual(a, qj, rj), GRADE[mode])
    _same_grade(orth, jvalidation.orthogonality(qj), GRADE[mode])


def test_device_metrics_are_calibrated_against_host_fp64():
    a = torch.from_numpy(_rand(2000, 40, 1))
    q, r = blockqr.qr(a, "bf16x6_cor", device="cpu")
    # at float32's own grade the float32 measurement's noise is of the
    # metric's size: the same order (the reference's calibration, 3.48e-7
    # on the device against 2.82e-7 on the host)
    host = accuracy.metrics_of(a, q, r, "host")
    dev = accuracy.metrics_of(a, q, r, "device")
    for h, d in zip(host, dev):
        assert h / 2 <= d <= 2 * h
    # a factorization 1e-4 off: the device metrics read it to 1e-3
    qp = q + 1e-4 * torch.from_numpy(_rand(2000, 40, 2))
    host = accuracy.metrics_of(a, qp, r, "host")
    dev = accuracy.metrics_of(a, qp, r, "device")
    for h, d in zip(host, dev):
        assert d == pytest.approx(h, rel=1e-3)
    assert accuracy.resolve_metrics("auto", 1 << 13, 1 << 13) == "host"
    assert accuracy.resolve_metrics("auto", 1 << 14, 1 << 13) == "device"
    with pytest.raises(ValueError):
        accuracy.metrics_of(a, q, r, "bogus")


def test_accuracy_row_and_sweep():
    out = io.StringIO()
    rows, errors = accuracy.sweep([128], [8, 256], ["fp32"], trials=2,
                                  out=out, device="cpu")
    assert errors == [] and len(rows) == 1  # n > m is skipped
    assert set(rows[0]) == set(SAMPLE) - {"condition", "measured_condition",
                                          "diag", "offdiag"}
    assert out.getvalue().splitlines() == [accuracy.CSV_HEADER,
                                           accuracy.format_row(rows[0])]
    assert rows[0]["orthogonality"] < 1e-6 and rows[0]["residual"] < 1e-6
    # the same seed draws the same inputs
    again = accuracy.accuracy_row(128, 8, "fp32", trials=2, device="cpu")
    assert again["residual"] == rows[0]["residual"]
    _, errors = accuracy.sweep([128], [8], ["bogus"], trials=1, out=out,
                               device="cpu")
    assert len(errors) == 1 and errors[0].startswith("# error")


@pytest.mark.parametrize("mode", ["fp32", "bf16x6_cor", "golden"])
def test_cond_trial_matches_jax(mode):
    a, measured = latms.rand_matrix_with_cond(3, 512, 32, 1e4)
    assert measured >= 0.9e4
    res, orth = cond.cond_trial(torch.from_numpy(a), mode)
    if mode == "golden":
        qj, rj = jnp.linalg.qr(jnp.asarray(a))
    else:
        qj, rj = jblockqr.qr(jnp.asarray(a), mode)
    _same_grade(res, jvalidation.residual(a, qj, rj), 1e-6)
    _same_grade(orth, jvalidation.orthogonality(qj), 1e-6)


def test_cond_sweep_rows():
    out = io.StringIO()
    rows, errors = cond.sweep(256, 16, [4.0, 1e3], ["fp32", "golden"],
                              trials=1, out=out, device="cpu")
    assert errors == []
    # golden rows have no reorth variant
    assert [(r["compute_mode"], r["reorthogonalization"]) for r in rows] == [
        ("fp32", 0)] * 2 + [("fp32", 1)] * 2 + [("torch.linalg.qr", 0)] * 2
    assert all(r["orthogonality"] < 1e-6 for r in rows)
    assert rows[1]["measured_condition"] >= 900


@pytest.mark.parametrize("mode", ["fp32", "bf16_nocor"])
def test_eval_q_trial_matches_jax(mode):
    a = _rand(512, 32, 2)
    d, off = eval_q.eval_q_trial(torch.from_numpy(a), mode)
    qj, _ = jblockqr.qr(jnp.asarray(a), mode)
    dj, offj = jvalidation.orthogonality_each(qj)
    _same_grade(d, dj, GRADE[mode])
    _same_grade(off, offj, GRADE[mode])
    rows = eval_q.sweep([128], 16, [mode], reorths=(True,),
                        out=io.StringIO(), device="cpu")
    assert set(rows[0]) == {"m", "n", "compute_mode",
                            "reorthogonalization", "diag", "offdiag"}


def test_compare_matches_jax():
    a = _rand(256, 32, 4)
    got = compare.golden_diff(torch.from_numpy(a), "bf16x6_cor")
    ref = jcompare.compare_to_fp64_golden(64, 8, "bf16x6_cor")
    assert set(got) == set(ref)
    # the judgeable parts of R: diagonal and column-scaled, float32 grade
    assert got["r_diag_max_rel_diff"] < 1e-5
    assert got["r_colscaled_max_diff"] < 1e-5
    diff = compare.modes_diff(torch.from_numpy(a), "fp32", "bf16x6_cor")
    assert set(diff) == set(jcompare.compare_modes(64, 8, "fp32", "fp32"))
    same = compare.compare_modes(64, 8, "fp32", "fp32", device="cpu")
    assert same == {"q_max_rel_diff": 0.0, "r_max_rel_diff": 0.0}
    assert set(compare.compare_to_fp64_golden(64, 8, "fp32",
                                              device="cpu")) == set(ref)


def test_baseline_rows_have_jaxs_keys():
    out = io.StringIO()
    rows = baseline.accuracy_sweep([64], [8, 128], trials=1, out=out,
                                   device="cpu")
    assert set(rows[0]) == set(jbaseline.baseline_accuracy_row(64, 8,
                                                               trials=1))
    assert rows[0]["compute_mode"] == "torch.linalg.qr"
    assert rows[0]["orthogonality"] < 1e-6
    speed = baseline.speed_sweep([64], [8], out=out, device="cpu")
    assert set(speed[0]) == set(jbaseline.baseline_speed_row(64, 8))
    assert speed[0]["elapsed_time"] > 0


def _perturbed_q(m, n, seed=0, noise=1e-4):
    """An orthonormal Q with noise added: orthogonality ~ noise."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((m, n)))
    q = q + noise * np.random.default_rng(seed + 1).standard_normal((m, n))
    return q.astype(np.float32)


def test_host_metrics_match_jax():
    q = _perturbed_q(300, 40)
    qt = torch.from_numpy(q)
    np.testing.assert_allclose(validation.orthogonality_each(qt),
                               jvalidation.orthogonality_each(q), rtol=1e-12)
    np.testing.assert_allclose(validation.submatrix_orthogonality(qt, 16),
                               jvalidation.submatrix_orthogonality(q, 16),
                               rtol=1e-12)
    qs = np.stack([q, _perturbed_q(300, 40, 5, 1e-3)])
    assert validation.multi_orthogonality(torch.from_numpy(qs)) == \
        pytest.approx(jvalidation.multi_orthogonality(qs), rel=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_metrics_match_jax(dtype):
    m, n = 1000, 40
    q = _perturbed_q(m, n, 2)
    r = np.triu(_rand(n, n, 3))
    a = (q.astype(np.float64) @ r + 1e-4 * _rand(m, n, 4)).astype(np.float32)
    qt = torch.from_numpy(q).to(dtype)
    qn = qt.float().numpy()
    qj = jnp.asarray(qn).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                else jnp.float32)
    at, rt = torch.from_numpy(a), torch.from_numpy(r)
    pairs = [
        (validation.orthogonality_device(qt),
         jvalidation.orthogonality_device(qj)),
        (validation.residual_device(at, qt, rt),
         jvalidation.residual_device(jnp.asarray(a), qj, jnp.asarray(r))),
        (validation.orthogonality_wide_device(qt, col_block=16,
                                              row_chunk=96),
         jvalidation.orthogonality_wide_device(qj, col_block=16,
                                               row_chunk=96)),
        (validation.residual_device_chunked(at, qt, rt, row_chunk=96),
         jvalidation.residual_device_chunked(jnp.asarray(a), qj,
                                             jnp.asarray(r), row_chunk=96)),
        (validation.residual_regen_chunked(
            lambda i: at[i * 100:(i + 1) * 100], qt, rt, 100),
         jvalidation.residual_regen_chunked(
            lambda i: jnp.asarray(a[i * 100:(i + 1) * 100]), qj,
            jnp.asarray(r), 100)),
    ]
    host_orth = validation.orthogonality(qn)
    host_res = validation.residual(a, qn, r)
    for k, (port, ref) in enumerate(pairs):
        assert port.dtype == torch.float32 and port.dim() == 0
        host = host_orth if k in (0, 2) else host_res
        assert float(port) == pytest.approx(float(ref), rel=1e-3)
        assert float(port) == pytest.approx(host, rel=1e-3)
    with pytest.raises(ValueError, match="divide"):
        validation.residual_regen_chunked(lambda i: at, qt, rt, 300)


def test_exponent_study_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4000)
         * 2.0 ** rng.integers(-150, 130, 4000)).astype(np.float32)
    x[:7] = [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-40, np.nan]
    xt = torch.from_numpy(x)
    for e in (-14, 0, -126, -130, -150, 127, 200):
        got = experimental.min_exponent(xt, e).numpy()
        ref = np.asarray(jexperimental.min_exponent(jnp.asarray(x), e))
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    for lo, hi in ((-14, 15), (-126, 127), (-150, 128), (-3, 2), (-130, 200)):
        got = experimental.clamp_exponent_range(xt, lo, hi).numpy()
        ref = np.asarray(jexperimental.clamp_exponent_range(jnp.asarray(x),
                                                            lo, hi))
        nan = np.isnan(ref)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(got[~nan].view(np.int32),
                              ref[~nan].view(np.int32))
    assert validation.exponent_distribution(xt) == \
        jvalidation.exponent_distribution(x)
    assert validation.exponent_distribution(torch.zeros(3)) == {}


def test_fp16_range_study_matches_jax():
    # the same float64-LAPACK QR in both: the study's numbers agree
    a = _rand(300, 20, 6) * np.float32(1e-3)

    def np_qr(x):
        q, r = np.linalg.qr(np.asarray(x, np.float64))
        return q.astype(np.float32), r.astype(np.float32)

    got = experimental.fp16_range_study(
        torch.from_numpy(a),
        lambda x: tuple(map(torch.from_numpy, np_qr(x.numpy()))))
    ref = jexperimental.fp16_range_study(jnp.asarray(a),
                                         lambda x: tuple(map(jnp.asarray,
                                                             np_qr(x))))
    assert set(got) == set(ref)
    assert got["exponent_hist"] == ref["exponent_hist"]
    for k in ("orthogonality", "orthogonality_fp16_range", "residual",
              "residual_fp16_range"):
        assert got[k] == pytest.approx(ref[k], rel=1e-9)


def test_timers_return_seconds_on_the_cpu():
    a = torch.from_numpy(_rand(64, 64))

    def fn(x):
        return x @ x

    assert timing.time_fn(fn, [a, 2 * a], iters=3, warmup=1) > 0
    assert timing.time_fn_amortized(fn, a, loops=3, reps=2) > 0
    assert timing.time_fn_distinct(fn, [a, 2 * a], reps=2) > 0
    t, loops = timing.time_fn_amortized_auto(fn, a, reps=1,
                                             min_active=1e-3)
    assert t > 0 and isinstance(loops, int) and loops >= 4
    # one no-op call is far below what a timer resolves
    assert np.isnan(timing.time_fn_amortized(lambda x: None, a, loops=1,
                                             reps=5, resolution_nan=True))


@pytest.mark.parametrize("ablate", ["no_panel", "no_project"])
@pytest.mark.parametrize("loop", ["unroll", "fori"])
def test_blockqr_ablation_matches_jax(ablate, loop):
    a = _rand(256, 40, 7)
    q, r = blockqr.qr(torch.from_numpy(a), "fp32", panel_width=16,
                      loop=loop, _ablate=ablate, device="cpu")
    qj, rj = jblockqr.qr(jnp.asarray(a), "fp32", panel_width=16, loop=loop,
                         _ablate=ablate)
    assert _rel(q, qj) <= 1e-5 and _rel(r, rj) <= 1e-5


def test_blockqr_ablation_contracts():
    a = torch.from_numpy(_rand(128, 32, 8)).requires_grad_(True)
    with pytest.raises(ValueError, match="_ablate"):
        blockqr.qr(a, _ablate="bogus", device="cpu")
    launches = trace.counts("launches.")["panel_qr"]
    q, r = blockqr.qr(a, "fp32", panel_width=16, _ablate="no_panel",
                      device="cpu")
    # no panel factorization: Q is the projected A, R's diagonal blocks I
    assert torch.equal(r[16:, 16:], torch.eye(16))
    assert trace.counts("launches.")["panel_qr"] == launches
    # the gradient rule does not wrap an ablated call
    assert type(q.grad_fn).__name__ != "_EntryQRBackward"
    q, _ = blockqr.qr(a, "fp32", panel_width=16, device="cpu")
    assert type(q.grad_fn).__name__ == "_EntryQRBackward"


def test_phase_profiles_have_jaxs_keys():
    out = io.StringIO()
    got = profile.blockqr_breakdown(128, 32, panel_width=16, out=out,
                                    device="cpu")
    ref = jprofile.blockqr_breakdown(64, 16, panel_width=8,
                                     out=io.StringIO())
    assert set(got) == set(ref)
    assert out.getvalue().startswith("# blockqr breakdown m=128 n=32 ")
    got = profile.tsqr_phase_split(512, 8, out=out, device="cpu",
                                   leaf_rows=64)
    assert set(got) == set(jprofile.tsqr_phase_split(64, 8,
                                                     out=io.StringIO()))
    assert all(v == v for v in got.values())  # no NaN


def test_trace_writes_a_chrome_trace(tmp_path):
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with profile.trace(str(tmp_path), activities=cpu) as tr:
        blockqr.qr(torch.from_numpy(_rand(128, 16)), device="cpu")
    assert tr.logdir == str(tmp_path)
    assert os.path.dirname(tr.path) == str(tmp_path)
    assert os.path.getsize(tr.path) > 0
    s = tr.summary()
    assert s["kernels"] == 0 and s["busy_share"] == 0 and s["wall_ms"] > 0
    assert profile._union_us([(0, 2), (1, 3), (5, 6)]) == 4
    tr.kernels = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("a", 5.0, 6.0)]
    tr.span_us = (0.0, 10.0)
    s = tr.summary(top=1)
    assert s["busy_share"] == pytest.approx(0.4)
    assert s["top"] == [{"name": "a", "total_ms": 3e-3, "calls": 2}]
    # CUDA asked for and nothing recorded: an error, not an empty trace
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA kernel"):
            with profile.trace(str(tmp_path), activities=cpu + [
                    torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(4).sum()
