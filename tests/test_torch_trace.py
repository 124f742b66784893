"""The port's spans and counters (``tsqr_tpu_torch/utils/trace.py``): off
by default at no clock read, the collector's ids and self time on the
ladder, the tier histogram, and the spans on a ``torch.profiler`` trace's
clock."""

import json
import time

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from tsqr_tpu_torch.core import auto
from tsqr_tpu_torch.utils import trace

MODE = "bf16x6_cor"


def _input(m=4096, n=8, zero_column=None):
    a = np.random.default_rng(m + n).uniform(-1, 1, (m, n))
    if zero_column is not None:
        a[:, zero_column] = 0.0
    return torch.from_numpy(a.astype(np.float32))


def _ladder(a):
    return auto.qr_auto_fused(a, MODE, return_info=True, device="cpu")


def _union_ns(intervals):
    covered, reach = 0, None
    for t0, t1 in sorted(intervals):
        if reach is None or t0 >= reach:
            covered += t1 - t0
            reach = t1
        elif t1 > reach:
            covered += t1 - reach
            reach = t1
    return covered


def test_off_builds_no_annotation_and_reads_no_clock(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the off path built an annotation or read "
                             "a clock")

    assert trace._collector is None and not trace._profiling()
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(trace.time, "perf_counter_ns", boom)
    with trace.span("ladder", m=1) as sp:
        assert sp is trace._OFF
        sp.set(tier=1)
    with pytest.raises(ValueError):   # the no-op lets an exception through
        with trace.span("x"):
            raise ValueError
    before = trace.counts()
    q, r, info = _ladder(_input(512))
    assert info["tier"] == 1
    assert trace.counts() - before == {"ladder.tier1": 1,
                                       "sync.tier1_gate": 1}


def test_collector_ids_and_self_time_on_a_ladder_call():
    a = _input(512)
    with trace.collect() as col:
        _, _, info = _ladder(a)
    assert trace._collector is None
    spans = col.spans
    ladder = spans[0]
    assert (ladder.name, ladder.parent, ladder.root) == ("ladder", None, 0)
    assert ladder.attrs == {"m": 512, "n": 8, "mode": MODE, "tier": 1}
    assert [s.name for s in spans] == [
        "ladder", "ladder.tier0", "stream", "stream", "sync",
        "ladder.tier1", "stream"]
    assert [s.parent for s in spans] == [None, 0, 1, 2, 1, 0, 5]
    assert all(s.root == 0 for s in spans)
    for s in spans[1:]:
        outer = spans[s.parent]
        assert outer.t0 <= s.t0 <= s.t1 <= outer.t1
    assert col.descendants(0) == spans[1:]
    assert col.descendants(1) == spans[2:5]
    assert spans[4].attrs == {"site": "tier1_gate"}
    # self time: the length less the union of the named descendants
    length = ladder.t1 - ladder.t0
    children = length - (spans[1].t1 - spans[1].t0) \
        - (spans[5].t1 - spans[5].t0)
    assert col.self_ns(0) == children
    named = ("stream", "sync")
    want = length - _union_ns([(s.t0, s.t1) for s in spans[1:]
                               if s.name in named])
    assert col.self_ns(0, named) == want
    assert 0 <= col.self_ns(0) <= want <= length
    assert col.self_ns(2, ("stream",)) == (spans[2].t1 - spans[2].t0) \
        - (spans[3].t1 - spans[3].t0)


@pytest.mark.parametrize("zero_column, tier", [(None, 1), (3, 4)])
def test_tier_histogram_and_the_tree_spans(zero_column, tier):
    a = _input(4096, zero_column=zero_column)
    before = trace.counts("ladder.")
    with trace.collect() as col:
        _, _, info = _ladder(a)
    assert info["tier"] == tier
    assert trace.counts("ladder.") - before == {f"tier{tier}": 1}
    names = [s.name for s in col.spans]
    tiers = [n for n in names if n.startswith("ladder.tier")]
    if tier == 1:
        assert tiers == ["ladder.tier0", "ladder.tier1"]
        return
    assert tiers == ["ladder.tier0", "ladder.tier2", "ladder.tier3",
                     "ladder.tier4"]
    # BlockQR's CGS2 over one panel: two factorizations, each a tree of
    # its leaves, one level of inner nodes (eight leaves, fan-in 8) and Q
    # down the tree; the leaves and the level each one panel-kernel call
    t4 = col.spans[names.index("ladder.tier4")]
    inside = [s.name for s in col.descendants(t4.sid)]
    assert inside == ["blockqr"] + ["blockqr.panel", "tsqr.tree",
                                    "tsqr.leaves", "panel", "tsqr.level",
                                    "panel", "tsqr.q_build"] * 2
    assert [s.attrs for s in col.spans if s.name == "blockqr.panel"] == [
        {"c0": 0, "w": 8, "pass": 1}, {"c0": 0, "w": 8, "pass": 2}]
    level = next(s for s in col.spans if s.name == "tsqr.level")
    assert level.attrs == {"batch": 1, "fanin": 8, "impl": "pallas_sb"}
    assert [s.attrs for s in col.spans if s.name == "panel"][:2] == [
        {"kernel": "panel_qr", "batch": 8, "L": 512, "n": 8, "cluster": 1},
        {"kernel": "panel_qr", "batch": 1, "L": 64, "n": 8, "cluster": 1}]
    sites = {s.attrs["site"] for s in col.spans if s.name == "sync"}
    assert sites == {"tier1_gate", "tier2_gate", "tier3_gate", "iter_loop"}


def test_spans_sit_on_the_profiler_clock(tmp_path):
    """Each span's annotation in a CPU profiler trace lies within 200 us
    of its collector record mapped onto the wall clock (after a first
    profiler session: a process's first annotation starts ~1 ms early)."""
    a = _input(512)
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        _ladder(a)
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=cpu) as prof:
        with trace.collect() as col:
            _ladder(a)
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    names = {s.name for s in col.spans}
    marks = sorted((e["ts"] + base_us, e["ts"] + e["dur"] + base_us,
                    e["name"]) for e in doc["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in names)
    assert [m[2] for m in marks] == [s.name for s in col.spans]
    for (t0, t1, _), s in zip(marks, col.spans):
        assert abs(t0 - col.wall(s.t0) / 1e3) < 200
        assert abs(t1 - col.wall(s.t1) / 1e3) < 200


def test_collector_writes_json_lines_and_is_one_at_a_time(tmp_path):
    with trace.collect() as col:
        with pytest.raises(RuntimeError, match="already open"):
            trace.collect()
        with trace.span("outer", k=1) as sp:
            with trace.span("inner"):
                time.sleep(0.001)
            sp.set(done=True)
    path = tmp_path / "spans.jsonl"
    col.write(path)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [(x["sid"], x["name"], x["parent"], x["root"], x["attrs"])
            for x in lines] == [(0, "outer", None, 0, {"k": 1, "done": True}),
                                (1, "inner", 0, 0, {})]
    assert lines[0]["start_ns"] <= lines[1]["start_ns"] \
        < lines[1]["end_ns"] <= lines[0]["end_ns"]
    assert abs(lines[0]["start_ns"] - time.time_ns()) < 60e9
    trace.count("test.x", 2)
    assert trace.counts("test.")["x"] >= 2
    assert trace.counts("test.")["never"] == 0
