"""The port's headline bench (``tsqr_tpu_torch/harness/bench.py`` behind
``bench_torch.py``) on the CPU: bench.py's JSON keys, its orthogonality
gate, the card as the default device, and the timed call against the JAX
package's ``qr_auto_fused`` under bench.py's TPU arguments."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsqr_tpu.core import auto as jauto
from tsqr_tpu_torch.core import auto
from tsqr_tpu_torch.harness import bench
from tsqr_tpu_torch.utils import validation

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"metric", "value", "unit", "vs_baseline"}  # bench.py:95-100
TOL = auto._TOL[auto.M("bf16x6_cor")]  # 1e-5


def _check_line(out: dict) -> None:
    assert set(out) == KEYS
    assert out["metric"] == "qr_auto_bf16x6_cor_tflops"
    assert out["unit"] == "TFLOP/s"
    assert out["value"] > 0 and out["vs_baseline"] > 0


@pytest.mark.parametrize("n", [16, 128])
def test_run_prints_bench_py_keys(n):
    # the gate passes (orthogonality < 1e-5) on uniform inputs at both n
    _check_line(bench.run(4096, n, 2, device="cpu"))


@pytest.mark.parametrize("tflops,want", [(44.13149, 44.131),
                                         (0.00041234, 0.000412), (0.0, 0.0)])
def test_value_is_zero_only_when_the_rate_is(tflops, want):
    # bench.py's 3 decimals, but a slow device's rate does not read as a
    # failed gate
    assert bench.reported(tflops) == want


def test_gate_zeroes_the_value(monkeypatch):
    monkeypatch.setattr(validation, "orthogonality_accurate",
                        lambda q: 1e-3)
    out = bench.run(4096, 16, 2, device="cpu")
    assert out["value"] == 0.0 and out["vs_baseline"] > 0


def test_run_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run(4096, 16, 2)


def test_timed_call_matches_jax_under_bench_py_arguments():
    a = np.random.default_rng(11).uniform(-1, 1, (4096, 128)).astype(
        np.float32)
    q, r, info = bench.ladder(torch.from_numpy(a), return_info=True)
    # bench.py:64-70, its TPU branch
    qj, rj, infoj = jauto.qr_auto_fused(
        jnp.asarray(a), "bf16x6_cor", fast_method="cholqr1_fused",
        mid_method="cholqr3_fused", mid_variant="compact", iter_tier=True,
        return_info=True)
    assert info["tier"] == int(np.asarray(infoj["tier"]).ravel()[0]) == 1
    qn, rn = q.numpy().astype(np.float64), r.numpy().astype(np.float64)
    qj, rj = np.asarray(qj, np.float64), np.asarray(rj, np.float64)
    assert np.linalg.norm(qn - qj) / np.linalg.norm(qj) <= TOL
    assert np.linalg.norm(rn - rj) / np.linalg.norm(rj) <= TOL
    assert validation.orthogonality(qn) < 1e-5
    assert validation.orthogonality(qj) < 1e-5


def test_bench_torch_single_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "--single", "4096",
         "2", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    _check_line(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "tier=1" in p.stderr and "torch.linalg.qr" in p.stderr


def test_bench_torch_exits_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    p = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "no card is available" in p.stderr
