"""Shared by the benchmark's tests: run the command in a subprocess."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUN = ROOT / "qrbench" / "run.py"
# the tiny CPU size of each cell (rows, inputs): a run takes seconds
TINY = {"tall128.well": (4096, 2), "wide1024.well": (8192, 2),
        "tall128.rankdef": (4096, 2), "rows4_tall128.well": (8192, 1)}
ROWS4 = "rows4_tall128.well"
# the four-chip cell's limits at the tiny CPU size, which reads
# 3.7e-7 / 4e-8 / 1.9e-7 (the cell is out of BENCHMARK.json: PERF.md §7)
ROWS4_LIMITS = {"orth": 2e-6, "resid": 1e-6, "r_err": 5e-7}


def rows4_root(dest: Path) -> Path:
    """A copy of the harness whose BENCHMARK.json also holds the four-chip
    cell, with its configuration and metric files as they stand, and
    limits for the tiny size."""
    shutil.copytree(ROOT / "qrbench", dest / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "rows4_tall128", "reduced": [], "why": "four ranks",
        "source": "https://github.com/enp1s0/tsqr-gpu",
        "file": "qrbench/configs/rows4_tall128.json"})
    bench["workloads"].append({"name": ROWS4, "config": "rows4_tall128",
                               "traffic": "well", "chips": 4,
                               "why": "four ranks over gloo on the CPU"})
    bench["per_layer"].append({
        "name": "comm.ms_per_call", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "collectives",
        "moves": "qr_tflops", "workloads": [ROWS4]})
    for e in bench["end_to_end"]:
        if "tall128.well" in e.get("workloads", []):
            e["workloads"].append(ROWS4)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    (dest / "qrbench" / "limits" / f"{ROWS4}.json").write_text(
        json.dumps(ROWS4_LIMITS))
    return dest


def run_cell(workload: str, *extra: str, seed: int = 2_300_000_017,
             root: Path = ROOT, timeout: float = 300.0):
    """(returncode, stdout lines, stderr) of one tiny CPU run."""
    m, k = TINY[workload]
    cmd = [sys.executable, str(root / "qrbench" / "run.py"),
           "--workload", workload, "--seed", str(seed), "--seconds", "0",
           "--trace", "0", "--device", "cpu", "--m", str(m),
           "--inputs", str(k), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    if root != ROOT:   # the program stays where it is
        env["PYTHONPATH"] = str(ROOT)
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=timeout, env=env)
    return p.returncode, p.stdout.strip().splitlines(), p.stderr


def last_line(workload: str, *extra: str, **kw) -> dict:
    rc, out, err = run_cell(workload, *extra, **kw)
    assert rc == 0, err[-3000:]
    return json.loads(out[-1])
