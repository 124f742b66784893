"""Find a cell and everything it is made of, by the names in
``BENCHMARK.json``.

- a configuration: the file that ``BENCHMARK.json`` gives for it (under
  ``qrbench/configs/``): the entry, its arguments, the shape, the mode,
  the inputs a run keeps resident and, on several chips, the mesh;
- a traffic mix: ``qrbench/traffic/<traffic>.json``, the parameters that
  ``generate.make_inputs`` reads;
- the limits of the comparison that decides ``correct``:
  ``qrbench/limits/<workload>.json``;
- a per-layer metric: ``qrbench/metrics/<metric>.py``, with ``SPANS``
  (the ``"module:function"`` targets it reads, ``spans.Recorder``) and
  ``read(view)``, which returns the value or None where it finds nothing
  to read; a device-trace metric that joins nothing to host operators
  may set ``HOST_OPS = False`` to be read from a trace of CUDA activity
  alone (``loop.run_process``).

So a cell, a mix or a metric is added by adding files and entries; no
file of the harness changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def m(self) -> int:
        return int(self.config["m"])

    @property
    def n(self) -> int:
        return int(self.config["n"])


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    mix = load_json(root / "qrbench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "qrbench" / "limits" / f"{workload}.json")
    e2e = [e for e in bench["end_to_end"] if _applies(e, workload)]
    reported = {e["name"] for e in e2e}
    layer = [e for e in bench["per_layer"]
             if e["moves"] in reported and _applies(e, workload)]
    return Cell(workload, int(w["chips"]), config, mix, limits, e2e, layer)


def load_metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``."""
    path = root / "qrbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"qrbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "read"):
        raise AttributeError(f"{path} has no read(view)")
    return mod


def resolve(target: str):
    """The object named ``"module:attribute"``."""
    mod_name, attr = target.split(":")
    return getattr(importlib.import_module(mod_name), attr)
