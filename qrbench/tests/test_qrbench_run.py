"""The command end to end on the CPU at a tiny size: the last line's
keys, the import guard, and the refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from qrbench.tests._helpers import ROOT, last_line, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]
FORBIDDEN = {"jax", "jaxlib", "flax", "tsqr_tpu"}


@pytest.mark.parametrize("workload", ["tall128.well", "wide1024.well",
                                      "tall128.rankdef",
                                      "rows4_tall128.well"])
def test_last_line_has_the_required_keys(workload, roots):
    root = roots(workload)
    line = last_line(workload, root=root)
    assert list(line) == KEYS          # check comes last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {e["name"] for e in bench["end_to_end"]
            if workload in e.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "x"   # no memory reading on the CPU
    dev = line["device"]
    assert set(dev) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert dev["platform"] == "cpu"     # never a device metric from a CPU
    for entry in line["check"].values():
        assert set(entry) == {"value", "limit"}


def test_traced_line_has_the_per_layer_metrics_only():
    rc, out, err = run_cell("tall128.rankdef", "--trace", "1")
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert list(line) == KEYS
    # on the CPU only the span readers find something to read
    assert set(line["metrics"]) <= {"tsqr.ms_per_tree",
                                    "householder.ms_per_tree"}
    assert "tsqr.ms_per_tree" in line["metrics"]
    assert err.strip().splitlines()[-1].startswith("check ")


_GUARD = """
import json, sys
sys.argv = ['qrbench/run.py'] + {args!r}
sys.path.insert(0, {root!r})
from qrbench import run
rc = run.main(sys.argv[1:])
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
sys.exit(rc)
"""


@pytest.mark.parametrize("workload", ["tall128.well", "rows4_tall128.well"])
def test_no_jax_loaded(workload, roots):
    """The command's process loads no module whose top-level name is JAX's
    or the JAX package's (compared whole), and the harness says so itself."""
    root = roots(workload)
    args = ["--workload", workload, "--seed", "5", "--seconds", "0",
            "--device", "cpu", "--m", "8192", "--inputs", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c",
                        _GUARD.format(args=args, root=str(root))],
                       cwd=root, capture_output=True, text=True, timeout=300,
                       env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    # one chip: the program runs in this process; several: in the ranks,
    # each of which reports its own modules to the same guard
    assert ("tsqr_tpu_torch" in tops) == (workload == "tall128.well")
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import qrbench.reference, "
            "qrbench.arith, qrbench.generate; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "tsqr_tpu_torch" not in p.stdout and "'jax'" not in p.stdout


def test_guard_refuses_a_loaded_jax_package(tmp_path):
    """With a module named ``tsqr_tpu`` loaded, the run exits 3 and prints
    no result."""
    (tmp_path / "tsqr_tpu.py").write_text("")
    code = ("import sys; sys.path[:0] = [%r, %r]; import tsqr_tpu; "
            "from qrbench import run; sys.exit(run.main(%r))"
            % (str(tmp_path), str(ROOT),
               ["--workload", "tall128.well", "--seed", "1", "--seconds",
                "0", "--device", "cpu", "--m", "2048", "--inputs", "1"]))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "tsqr_tpu" in p.stderr


def test_no_card_exits_without_a_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    p = subprocess.run([sys.executable, "qrbench/run.py", "--workload",
                        "tall128.well", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_harness_alone_exits_without_a_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the files under
    paths, the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "qrbench", tmp_path / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "qrbench/run.py", "--workload",
                        "tall128.well", "--seed", "1", "--seconds", "0",
                        "--trace", "0", "--device", "cpu", "--m", "2048",
                        "--inputs", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """On a card: one short run of the first cell is correct."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "qrbench/run.py", "--workload",
                        "tall128.well", "--seed", "4242", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
