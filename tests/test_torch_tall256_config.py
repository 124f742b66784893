"""The benchmark's ``tall256`` deployment on the CPU, judged as the
benchmark judges it.

The configuration's entry (``qrbench/configs/tall256.json``) is
``tsqr(a, "bf16x6_cor")`` with every other argument at its default.  At
(2048, 256) on the kernels' plain versions its tree has the cell's shape
at a small m: 8 square (256, 256) leaves, one level of (1024, 256) nodes
at fan-in 4 and a (512, 256) root at fan-in 2.  The benchmark's plain
float64 reference (``qrbench/reference.py``) judges Q and R at the
cell's limits (``qrbench/limits/tall256.well.json``), and a lower
precision fails at least one of them.
"""

import json
from pathlib import Path

import pytest

import _torch_threads  # noqa: F401
import tsqr_tpu_torch
from qrbench import cell as cell_mod, generate, reference
from tsqr_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
CELL = "tall256.well"
M = 2048
SEED = 11


def _cell():
    return cell_mod.find(CELL, ROOT)


def _inputs(seed):
    c = _cell()
    xs, _ = generate.make_inputs(c.mix, M, c.n, 1, seed, "cpu")
    return xs[0]


def _call(a, mode):
    c = _cell()
    entry = cell_mod.resolve(c.config["entry"])
    return entry(a, mode=mode, device="cpu", **c.config["kwargs"])


def test_the_config_is_tsqr_at_n256():
    c = _cell()
    assert cell_mod.resolve(c.config["entry"]) is tsqr_tpu_torch.tsqr
    assert c.config["kwargs"] == {} and c.config["mode"] == "bf16x6_cor"
    assert (c.m, c.n, c.chips) == (1 << 20, 256, 1)


def test_the_call_passes_the_cell_limits():
    a = _inputs(SEED)
    with trace.collect() as col:
        q, r = _call(a, "bf16x6_cor")
    got = reference.judge(a, q, r)
    limits = _cell().limits
    assert set(limits) == {"orth", "resid", "r_err"}
    assert all(got[k] <= limits[k] for k in limits), (got, limits)
    # the leaves and each level are one call of the wide panel kernel's
    # plain version
    panels = [s.attrs for s in col.spans if s.name == "panel"]
    assert panels == [{"kernel": "panel_wide", "batch": b, "L": L, "n": 256,
                       "cluster": 1}
                      for b, L in ((8, 256), (2, 1024), (1, 512))]
    levels = [s.attrs for s in col.spans if s.name == "tsqr.level"]
    assert [lv["fanin"] for lv in levels] == [4, 2]


@pytest.mark.parametrize("mode", ["bf16x3_cor", "bf16"])
def test_a_lower_precision_fails_the_cell_limits(mode):
    a = _inputs(SEED)
    got = reference.judge(a, *_call(a, mode))
    limits = _cell().limits
    assert any(not got[k] <= limits[k] for k in limits), (got, limits)
