"""The cell ``tall256.well`` on the CPU at a tiny size, and its three
per-layer readers on a device trace made by hand: the wide panel
kernel's roofline and the device time of a tree's inner levels and of
its Q build."""

import json
import os
import subprocess
import sys

import pytest

from qrbench import arith, cell as cell_mod, spans as spans_mod
from qrbench.tests._helpers import ROOT
from qrbench.tracing import Op, Trace

WORKLOAD = "tall256.well"
NEW = ("panel_wide_roofline", "tsqr.levels_device_ms_per_tree",
       "tsqr.q_build_device_ms_per_tree")


def _line(*extra):
    cmd = [sys.executable, str(ROOT / "qrbench" / "run.py"), "--workload",
           WORKLOAD, "--seed", "3000000019", "--seconds", "0",
           "--device", "cpu", "--m", "2048", "--inputs", "2", *extra]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("traced", [0, 1])
def test_the_cell_runs_and_is_correct(traced):
    line = _line("--trace", str(traced))
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    if traced:
        # device-trace readers: nothing to read on the CPU, so left out
        assert not set(line["metrics"]) & set(NEW)
    else:
        assert set(line["metrics"]) == {"qr_tflops.wide", "call_ms_p95.wide",
                                        "peak_mem_over_a", "setup_s"}


def test_the_cell_reports_its_new_metrics():
    c = cell_mod.find(WORKLOAD)
    assert {e["name"] for e in c.per_layer} == {"device.idle_share.wide",
                                                *NEW}
    assert all(e["moves"] == "qr_tflops.wide" for e in c.per_layer)


class _View:
    def __init__(self, trace, spans=None):
        self.trace, self.spans = trace, spans


def _trace():
    """Two trees in a window of 0..1000 us: each a level span launching
    two kernels that overlap, and a Q build span launching one; one kernel
    launched outside any span; the spans' annotations nest in the tree's."""
    host = []
    ops = []
    for t in (0, 500):
        host += [(t + 10, t + 400, "tsqr.tree"),
                 (t + 20, t + 100, "tsqr.level"),
                 (t + 30, t + 40, "panel"),
                 (t + 200, t + 300, "tsqr.q_build"),
                 (t + 210, t + 220, "aten::mm")]
        ops += [Op("wide_factor_kernel", t + 50, t + 90, t + 30),
                Op("wide_apply_kernel", t + 80, t + 110, t + 35),
                Op("gemm", t + 250, t + 270, t + 215),
                Op("pad", t + 120, t + 180, t + 150)]
    return Trace(window=(0.0, 1000.0), ops=ops, host=host)


def test_phase_readers_on_a_trace_made_by_hand():
    levels = cell_mod.load_metric("tsqr.levels_device_ms_per_tree")
    q_build = cell_mod.load_metric("tsqr.q_build_device_ms_per_tree")
    view = _View(_trace())
    # 60 us of the level's kernels (50..110) and 20 of the product a tree
    assert levels.read(view) == pytest.approx(60e-3)
    assert q_build.read(view) == pytest.approx(20e-3)
    assert levels.read(_View(None)) is None
    assert levels.read(_View(Trace(window=(0.0, 1.0)))) is None


def test_panel_wide_roofline_keeps_the_wide_calls_alone():
    mod = cell_mod.load_metric("panel_wide_roofline")
    key = "tsqr_tpu_torch.ops.panel_kernel.panel_qr_batched"

    def span(sid, t0, t1, shape):
        return spans_mod.Span(key, sid, t0, t1, {
            "a": {"shape": list(shape), "dtype": "float32",
                  "device": "cuda"}, "mode": "bf16x6_cor"}, ())

    rec = spans_mod.Recorder([])
    rec.spans = [span(0, 0, 1, (4096, 256, 256)),
                 span(1, 0, 1, (1024, 1024, 256)),
                 span(2, 0, 1, (4096, 256, 128))]
    tr = Trace(window=(0.0, 1e4),
               spans={0: (key, 0.0, 100.0), 1: (key, 200.0, 300.0),
                      2: (key, 400.0, 500.0)},
               ops=[Op("w", 10.0, 2010.0, 50.0),
                    Op("w", 2010.0, 3010.0, 250.0),
                    Op("narrow", 3100.0, 9000.0, 450.0)])
    bound_ms = (arith.panel_bound(4096, 256, 256, "bf16x6_cor")["bound_ms"]
                + arith.panel_bound(1024, 1024, 256, "bf16x6_cor")
                ["bound_ms"])
    assert mod.read(_View(tr, rec)) == pytest.approx(
        100.0 * bound_ms / 3.0)
    assert mod.read(_View(None, rec)) is None
