"""The harness finds every configuration, mix, limit file and per-layer
metric by its name in BENCHMARK.json, and a new one is added by adding
files alone; BENCHMARK.json keeps its required shape and limits."""

import json
import re
import shutil

import pytest

from qrbench import cell as cell_mod, generate
from qrbench.tests._helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_resolves(workload):
    c = cell_mod.find(workload)
    assert c.chips in (1, 4)
    assert c.config["chips"] == c.chips
    assert set(c.limits) == {"orth", "resid", "r_err"}
    # a rate under its own name or a group's (``qr_tflops.wide``)
    assert {e["name"].split(".")[0] for e in c.end_to_end} >= {
        "setup_s", "qr_tflops"}
    assert c.per_layer
    for entry in c.per_layer:
        mod = cell_mod.load_metric(entry["name"])
        assert callable(mod.read)
        for target in mod.SPANS:
            assert callable(cell_mod.resolve(target)), target
    cell_mod.resolve(c.config["entry"])


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "qrbench/run.py"]
    assert BENCH["paths"] == ["qrbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("qrbench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        names.add(c["name"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == names
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for group in (["configs"], ["workloads"], ["end_to_end", "per_layer"]):
        group_names = [x["name"] for k in group for x in BENCH[k]]
        assert len(set(group_names)) == len(group_names)
        for name in group_names:
            assert NAME.match(name), name
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert set(e) - {"workloads"} <= {"name", "unit", "better", "bound",
                                          "source", "layer", "moves"}
        for w in e.get("workloads", []):
            assert w in WORKLOADS
    for e in BENCH["per_layer"]:
        assert e["moves"] in e2e
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in e["layer"] and len(e["layer"]) <= 200
    for e in BENCH["per_layer"]:   # each listed cell reports `moves`
        for w in e.get("workloads", WORKLOADS):
            assert w in e2e[e["moves"]].get("workloads", WORKLOADS), e
    for w in BENCH["workloads"]:
        reported = {e["name"] for e in BENCH["end_to_end"]
                    if w["name"] in e.get("workloads", WORKLOADS)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(e["moves"] in reported
                   and w["name"] in e.get("workloads", WORKLOADS)
                   for e in BENCH["per_layer"])
        assert len(w["why"]) <= 200
        assert (ROOT / "qrbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()


def test_a_new_mix_and_metric_need_no_edit(tmp_path):
    """A throwaway mix, cell, limits and metric, added as files in a copy:
    the harness finds them without a change to its own files."""
    shutil.copytree(ROOT / "qrbench", tmp_path / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tall128.halfrange",
                               "config": "tall128", "traffic": "halfrange",
                               "chips": 1, "why": "a throwaway cell"})
    for e in bench["end_to_end"]:
        if e["name"] == "qr_tflops":
            e["workloads"].append("tall128.halfrange")
    bench["per_layer"].append({"name": "throwaway.calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "qr_tflops",
                               "workloads": ["tall128.halfrange"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "qrbench" / "traffic" / "halfrange.json").write_text(
        json.dumps({"low": 0.0, "high": 0.5, "zero_columns": 2}))
    (tmp_path / "qrbench" / "limits" / "tall128.halfrange.json").write_text(
        json.dumps({"orth": 1.0, "resid": 1.0, "r_err": 1.0}))
    (tmp_path / "qrbench" / "metrics" / "throwaway.calls.py").write_text(
        "SPANS = []\n\n\ndef read(view):\n    return float(view.calls)\n")
    c = cell_mod.find("tall128.halfrange", tmp_path)
    assert c.mix["high"] == 0.5
    assert [e["name"] for e in c.per_layer][-1] == "throwaway.calls"
    mod = cell_mod.load_metric("throwaway.calls", tmp_path)
    assert mod.read(type("V", (), {"calls": 3})()) == 3.0
    xs, info = generate.make_inputs(c.mix, 64, 8, 2, 5, "cpu")
    assert all(float(x.max()) < 0.5 and len(i["zero_columns"]) == 2
               for x, i in zip(xs, info))


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        cell_mod.find("no_such.cell")
