"""The cell ``block8192.well`` on the CPU at a small size, its three
per-layer readers on device traces made by hand, and faults planted under
its panel steps (``faults_blockqr.py``) that must read not correct.

The harness shrinks m alone (``--m``), and the cell's n = 8192 is far
past a CPU run, so the runs start from a copy of the harness whose
configuration has n = 512: (2048, 512), the cell's m / n = 4, four
panels and eight trees a call."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from qrbench import arith, cell as cell_mod, spans as spans_mod
from qrbench.tests._helpers import ROOT
from qrbench.tracing import Op, Trace

WORKLOAD = "block8192.well"
NEW = ("blockqr.project_device_ms_per_call",
       "blockqr.panels_device_ms_per_call", "blockqr_project_roofline")
M, N = 2048, 512
F = "qrbench.tests.faults_blockqr:"


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    dest = tmp_path_factory.mktemp("block8192")
    shutil.copytree(ROOT / "qrbench", dest / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    path = dest / "qrbench" / "configs" / "block8192.json"
    cfg = json.loads(path.read_text())
    cfg["n"] = N
    path.write_text(json.dumps(cfg))
    return dest


def _line(root, *extra):
    cmd = [sys.executable, str(root / "qrbench" / "run.py"), "--workload",
           WORKLOAD, "--seed", "3100000021", "--seconds", "0",
           "--device", "cpu", "--m", str(M), "--inputs", "1", *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("traced", [0, 1])
def test_the_cell_runs_and_is_correct(traced, small_root):
    line = _line(small_root, "--trace", str(traced))
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    if traced:
        # device-trace readers: nothing to read on the CPU, so left out;
        # the trees' host time is read from the wrapped tsqr
        assert not set(line["metrics"]) & {*NEW, "panel_kernel_roofline"}
        assert line["metrics"]["tsqr.ms_per_tree"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"qr_tflops", "call_ms_p95",
                                        "peak_mem_over_a", "setup_s"}


@pytest.mark.parametrize("fault", ["project_bf16", "project_tf32"])
def test_a_projection_below_float32_is_not_correct(fault, small_root):
    line = _line(small_root, "--trace", "0", "--prepare", F + fault)
    assert line["correct"] is False, line["check"]
    assert line["failed"] >= 1


def test_the_cell_reports_its_new_metrics():
    c = cell_mod.find(WORKLOAD)
    assert {e["name"] for e in c.per_layer} == {
        "device.idle_share", "panel_kernel_roofline", "tsqr.ms_per_tree",
        *NEW}
    assert all(e["moves"] == "qr_tflops" for e in c.per_layer)
    assert c.config["kwargs"] == {"reorth": True}


class _View:
    def __init__(self, trace, spans=None, cell=None):
        self.trace, self.spans, self.cell = trace, spans, cell


def _trace(with_phases=True):
    """Two BlockQR calls in a window of 0..1000 us, the first starting
    before it: each a projection span launching two kernels that overlap
    and a panel span launching one, and a kernel launched outside both."""
    host, ops = [], []
    for t in (-100, 500):
        host.append((t + 10, t + 400, "blockqr"))
        if with_phases:
            host += [(t + 20, t + 100, "blockqr.project"),
                     (t + 200, t + 300, "blockqr.panel"),
                     (t + 210, t + 220, "tsqr.tree")]
        ops += [Op("gemm", t + 150, t + 190, t + 30),
                Op("gemm", t + 180, t + 210, t + 35),
                Op("panel_qr_kernel", t + 250, t + 270, t + 215),
                Op("copy", t + 300, t + 360, t + 350)]
    return Trace(window=(0.0, 1000.0), ops=ops, host=host)


def test_phase_readers_on_a_trace_made_by_hand():
    project = cell_mod.load_metric(NEW[0])
    panels = cell_mod.load_metric(NEW[1])
    view = _View(_trace())
    # the window holds both calls' kernels (60 us of projections and 20
    # of panels each) and the start of one call
    assert project.read(view) == pytest.approx(120e-3)
    assert panels.read(view) == pytest.approx(40e-3)
    # a program without the spans (the parent's), and the CPU
    assert project.read(_View(_trace(with_phases=False))) is None
    assert panels.read(_View(_trace(with_phases=False))) is None
    assert project.read(_View(None)) is None


def test_roofline_on_spans_made_by_hand():
    mod = cell_mod.load_metric("blockqr_project_roofline")
    key = "tsqr_tpu_torch.core.blockqr._project"
    cell = cell_mod.find(WORKLOAD)

    def span(sid, c):
        return spans_mod.Span(key, sid, 0, 1, {
            "mm": "function", "reduce": "function",
            "qp": {"shape": [32768, c], "dtype": "float32",
                   "device": "cuda"},
            "x": {"shape": [32768, 128], "dtype": "float32",
                  "device": "cuda"}}, ())

    rec = spans_mod.Recorder([])
    rec.spans = [span(0, 128), span(1, 8064), span(2, 4096)]
    tr = Trace(window=(0.0, 1e5),
               spans={0: (key, 0.0, 100.0), 1: (key, 200.0, 300.0),
                      2: (key, 400.0, 500.0)},
               ops=[Op("sgemm", 10.0, 1010.0, 50.0),
                    Op("sgemm", 1010.0, 4010.0, 250.0)])
    # the third span launched nothing: its bound is left out
    want = sum(mod.pass_bound_ms(32768, c, 128, "bf16x6_cor")
               for c in (128, 8064))
    assert mod.read(_View(tr, rec, cell)) == pytest.approx(
        100.0 * want / 4.0)
    assert mod.read(_View(None, rec, cell)) is None
    # the bound of the pass at c = 8064: bound by its 6 bf16 products
    flops = 2.0 * 32768 * 8064 * 128 * 6
    assert mod.pass_bound_ms(32768, 8064, 128, "bf16x6_cor") == \
        pytest.approx(2e3 * flops / arith.H100_BF16_FLOPS)
    assert mod.pass_bound_ms(32768, 8064, 128, "fp32") == pytest.approx(
        2e3 * flops / 6 / arith.H100_FP32_FLOPS)


def test_roofline_has_no_target_in_a_program_without_the_function(
        monkeypatch):
    from tsqr_tpu_torch.core import blockqr
    assert cell_mod.load_metric("blockqr_project_roofline").SPANS == [
        "tsqr_tpu_torch.core.blockqr:_project"]
    monkeypatch.delattr(blockqr, "_project")
    assert cell_mod.load_metric("blockqr_project_roofline").SPANS == []
