"""The benchmark's ``block8192`` deployment on the CPU, judged as the
benchmark judges it.

The configuration's entry (``qrbench/configs/block8192.json``) is
``qr(a, "bf16x6_cor", reorth=True)``: BlockQR with CGS2 over 128-column
TSQR panels.  At (4096, 1024), the cell's m / n = 4, a call is 8 panels,
16 trees and 28 projection products (7 panels past the first, two CGS
passes, two products a pass) on the kernels' plain versions.  The
benchmark's plain float64 reference (``qrbench/reference.py``) judges Q
and R at the cell's limits (``qrbench/limits/block8192.well.json``), and
the program's next lower precision fails at least one of them.
"""

from pathlib import Path

import pytest

import _torch_threads  # noqa: F401
import tsqr_tpu_torch
from qrbench import cell as cell_mod, generate, reference
from tsqr_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
CELL = "block8192.well"
M, N = 4096, 1024
SEED = 3100000013


def _cell():
    return cell_mod.find(CELL, ROOT)


def _call(a, mode):
    c = _cell()
    entry = cell_mod.resolve(c.config["entry"])
    return entry(a, mode=mode, device="cpu", **c.config["kwargs"])


@pytest.fixture(scope="module")
def a():
    xs, _ = generate.make_inputs(_cell().mix, M, N, 1, SEED, "cpu")
    return xs[0]


@pytest.fixture(scope="module")
def traced(a):
    """One call with the span collector open: (Q, R, spans, counters)."""
    before = trace.counts("blockqr.")
    with trace.collect() as col:
        q, r = _call(a, "bf16x6_cor")
    return q, r, col, trace.counts("blockqr.") - before


def test_the_config_is_cgs2_blockqr_at_2_15_by_2_13():
    c = _cell()
    assert cell_mod.resolve(c.config["entry"]) is tsqr_tpu_torch.qr
    assert c.config["kwargs"] == {"reorth": True}
    assert c.config["mode"] == "bf16x6_cor"
    assert (c.m, c.n, c.chips) == (1 << 15, 1 << 13, 1)


def test_the_call_passes_the_cell_limits(a, traced):
    q, r = traced[:2]
    got = reference.judge(a, q, r)
    limits = _cell().limits
    assert set(limits) == {"orth", "resid", "r_err"}
    assert all(got[k] <= limits[k] for k in limits), (got, limits)


def test_a_lower_precision_fails_the_cell_limits(a):
    got = reference.judge(a, *_call(a, "bf16x3_cor"))
    limits = _cell().limits
    assert any(not got[k] <= limits[k] for k in limits), (got, limits)


def test_one_call_counts_its_panels_and_projections(traced):
    assert traced[3] == {"panels": 8, "project": 28}


def test_the_spans_nest_panel_steps_in_the_call(traced):
    col = traced[2]
    by_sid = {s.sid: s for s in col.spans}

    def parent(s):
        return by_sid[s.parent].name if s.parent is not None else None
    calls = [s for s in col.spans if s.name == "blockqr"]
    panels = [s for s in col.spans if s.name == "blockqr.panel"]
    projects = [s for s in col.spans if s.name == "blockqr.project"]
    trees = [s for s in col.spans if s.name == "tsqr.tree"]
    assert len(calls) == 1 and calls[0].parent is None
    # two factorizations a panel (CGS2), a projection a pass past panel 0
    assert [(s.attrs["c0"], s.attrs["w"], s.attrs["pass"])
            for s in panels] == [(c0, 128, p) for c0 in range(0, N, 128)
                                 for p in (1, 2)]
    assert [(s.attrs["c0"], s.attrs["pass"]) for s in projects] == [
        (c0, p) for c0 in range(128, N, 128) for p in (1, 2)]
    assert {parent(s) for s in panels + projects} == {"blockqr"}
    assert len(trees) == 16 and {parent(s) for s in trees} == {
        "blockqr.panel"}
    # a projection launches no tree
    assert not any(parent(s) == "blockqr.project" for s in col.spans)


def test_the_factors_do_not_depend_on_the_collector(a, traced):
    q, r = _call(a, "bf16x6_cor")
    assert trace._collector is None
    assert q.equal(traced[0]) and r.equal(traced[1])
