"""The check that decides ``correct``: a run with the timed path broken
underneath, and the control (the program's own lower-precision path),
come out not correct; the sound run at the same size comes out correct.

Each case drives a whole run of the command on the CPU at a tiny size
(``--device cpu``, which skips the look for a card) and plants its fault
with ``--prepare qrbench.tests.faults:<name>`` in every process of the
run, below the entry the window drives.  The four-chip cell runs from a
copy that holds it (``roots``): it is out of the benchmark while the
program's distributed Gram misses its grade at full size.
"""

import pytest

from qrbench.tests._helpers import last_line

F = "qrbench.tests.faults:"
CASES = [
    # (workload, fault): each fault the cell's path can have
    ("tall128.well", "q_unchanged"),
    ("tall128.well", "gram_half_rows"),
    ("tall128.well", "q_row_altered"),
    ("wide1024.well", "q_unchanged"),
    ("wide1024.well", "gram_half_rows"),
    ("wide1024.well", "q_row_altered"),
    ("tall128.rankdef", "tree_unchanged"),
    ("tall128.rankdef", "leaves_half"),
    ("tall128.rankdef", "tree_row_altered"),
    ("rows4_tall128.well", "dist_q_unchanged"),
    ("rows4_tall128.well", "dist_gram_half_rows"),
    ("rows4_tall128.well", "no_exchange"),
    ("rows4_tall128.well", "dist_q_row_altered"),
]
WORKLOADS = sorted({w for w, _ in CASES})


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload, roots):
    line = last_line(workload, root=roots(workload))
    assert line["correct"] is True, line["check"]


@pytest.mark.parametrize("workload, fault", CASES)
def test_fault_is_not_correct(workload, fault, roots):
    line = last_line(workload, "--prepare", F + fault, root=roots(workload))
    assert line["correct"] is False, line["check"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("mode", ["bf16x3_cor", "bf16"])
def test_control_is_not_correct(workload, mode, roots):
    """The control: the program's nearest lower-precision paths in place of
    bf16x6_cor (two bf16 parts, one part)."""
    line = last_line(workload, "--mode", mode, root=roots(workload))
    assert line["correct"] is False, line["check"]
