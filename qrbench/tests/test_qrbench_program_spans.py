"""The metrics that read the program's own spans (``qrbench/program_spans.py``):
a tiny CPU ``--trace 1`` run of ``tall128.rankdef`` reads all three, and
the spans they read are window 0's calls.

The run goes through a copy of the harness whose ``BENCHMARK.json`` adds
one probe metric, ``probe.window0``, read as those three are.  With
``--prepare``, :func:`mark_windows` first notes each window's interval
on the host clock: the warm-up's, then windows 0, 1 and 2.  The probe
reads 1 where the calls the readers take lie inside window 0, and where
later windows called the program too (so that taking the first
``view.calls`` spans mattered)."""

import json
import math
import shutil
import time

from qrbench.tests._helpers import ROOT, run_cell

WORKLOAD = "tall128.rankdef"
METRICS = ("ladder.self_ms_per_call", "stream.self_us_per_call",
           "ladder.failed_tiers_ms_per_call")
WINDOWS: list = []   # (start, end) ns of each closed_loop in the process

PROBE = '''
from qrbench import program_spans as ps
from qrbench.tests import test_qrbench_program_spans as t

SPANS = []


def read(view):
    w0 = t.WINDOWS[1]                     # [0] is the warm-up
    calls = ps.window_calls(view)
    every = ps.outermost(ps.COLLECTOR.spans, "ladder")
    later = every[len(calls):]
    return float(len(calls) == view.calls >= 1
                 and all(w0[0] <= c.t0 and c.t1 <= w0[1] for c in calls)
                 and bool(later) and all(c.t0 > w0[1] for c in later))
'''


def mark_windows():
    """Note each ``closed_loop``'s interval in ``WINDOWS`` (the fault
    tests' hook, ``run.py --prepare``)."""
    from qrbench import loop

    inner = loop.closed_loop

    def timed(*args, **kwargs):
        t0 = time.perf_counter_ns()
        try:
            return inner(*args, **kwargs)
        finally:
            WINDOWS.append((t0, time.perf_counter_ns()))
    loop.closed_loop = timed


def test_program_span_metrics_read_window_0(tmp_path):
    shutil.copytree(ROOT / "qrbench", tmp_path / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "probe.window0", "unit": "x", "better": "higher",
        "source": "program_span", "layer": "pipelines",
        "moves": "qr_tflops", "workloads": [WORKLOAD]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "qrbench" / "metrics" / "probe.window0.py").write_text(PROBE)
    rc, out, err = run_cell(
        WORKLOAD, "--trace", "1", "--prepare",
        "qrbench.tests.test_qrbench_program_spans:mark_windows",
        root=tmp_path)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert line["correct"] is True
    got = line["metrics"]
    for name in METRICS:
        assert name in got and math.isfinite(got[name]["value"])
        assert got[name]["value"] > 0
    assert got["probe.window0"]["value"] == 1.0
