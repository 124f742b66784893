"""The benchmark of ``tsqr_tpu_torch``: one run of one cell.

    python3 qrbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs the cell named in ``BENCHMARK.json`` on the card(s) of this
machine (``qrbench/loop.py``; several chips: one process a chip,
``qrbench/ranks.py``) and prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted`` (calls in the window),
``failed`` (judged outputs over a limit), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with its limit, which are also the last lines of
standard error.  Exits 2 without the cards the cell asks for, and 3
if JAX or the JAX package was loaded.

For tests only: ``--device cpu`` runs on the CPU with the kernels' plain
versions, ``--m`` and ``--inputs`` shrink the cell, ``--mode`` runs
another of the program's modes (the control of ``qrbench/control.py``),
``--prepare module:function`` calls a function first in each process
(the fault tests plant their faults so).
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
    sys.path[0] = str(ROOT)   # import the harness as the package qrbench


def _log(msg: str) -> None:
    print(f"qrbench: {msg}", file=sys.stderr, flush=True)


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def end_to_end(cell, results) -> dict:
    """The cell's end-to-end metrics, from the ranks' results (rank 0
    times the calls).  A metric named ``<base>.<group>`` is ``<base>``,
    declared apart for a group of cells that spreads apart."""
    from qrbench import arith
    r0 = results[0]
    base = {
        "qr_tflops": arith.qr_flops(cell.m, cell.n) * r0["calls"]
        / r0["window_s"] / 1e12,
        "call_ms_p95": 1e3 * p95(r0["call_s"]),
        "peak_mem_over_a": max(r["over_bytes"] for r in results)
        / r0["input_bytes"],
        "setup_s": r0["setup_s"],
    }
    return {e["name"]: base[e["name"].split(".")[0]]
            for e in cell.end_to_end}


def per_layer(cell, results) -> dict:
    """Rank 0's per-layer values; a metric whose reader sets
    ``AVERAGE = True`` is the mean over the ranks that read it."""
    from qrbench import cell as cell_mod
    out = {}
    for entry in cell.per_layer:
        name = entry["name"]
        if getattr(cell_mod.load_metric(name), "AVERAGE", False):
            vals = [r["layer"][name] for r in results if name in r["layer"]]
            if vals:
                out[name] = statistics.fmean(vals)
        elif name in results[0]["layer"]:
            out[name] = results[0]["layer"][name]
    return out


def check(cell, results) -> tuple[dict, int, bool]:
    """The worst of each judged number over the outputs and ranks, beside
    its limit; the outputs over a limit; whether all are within."""
    limits = cell.limits
    worst = {name: None for name in limits}
    failed = set()
    judged = 0
    for r in results:
        judged += len(r["judged"])
        for j, numbers in enumerate(r["judged"]):
            for name, limit in limits.items():
                v = numbers.get(name)
                if v is None:
                    continue
                if not v <= limit:   # NaN fails
                    failed.add(j)
                if worst[name] is None or not v <= worst[name]:
                    worst[name] = v
    table = {name: {"value": worst[name], "limit": limits[name]}
             for name in limits if worst[name] is not None}
    ok = judged > 0 and bool(table) and not failed
    return table, len(failed), ok


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: tests only")
    p.add_argument("--m", type=int, default=None, help="tests only")
    p.add_argument("--inputs", type=int, default=None, help="tests only")
    p.add_argument("--mode", default=None, help="control only")
    p.add_argument("--prepare", default=None,
                   help="tests only: module:function run first in each "
                        "process (plants a fault)")
    args = p.parse_args(argv)

    import torch

    from qrbench import cell as cell_mod, loop, ranks

    c = cell_mod.find(args.workload, ROOT)
    if args.m:
        c.config["m"] = args.m
    if args.inputs:
        c.config["inputs"] = args.inputs
    card = args.device == "cuda"
    if card and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < c.chips):
        _log(f"{c.name} needs {c.chips} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    trace = bool(args.trace)
    if c.chips == 1:
        dev = torch.device("cuda", 0) if card else torch.device("cpu")
        results = [loop.run_process(c, args.seed, args.seconds, trace, dev,
                                    T_PROCESS, mode=args.mode,
                                    prepare=args.prepare)]
    else:
        results = ranks.launch(
            c.chips, loop.rank_run,
            (c, args.seed, args.seconds, trace, T_PROCESS, args.mode,
             args.device, args.prepare), backend="nccl" if card else "gloo")
    found = sorted(set(loop.forbidden_modules()).union(
        *(r.get("forbidden", []) for r in results)))
    if found:
        _log(f"JAX or the JAX package was loaded: {found}")
        return 3

    r0 = results[0]
    table, failed, ok = check(c, results)
    units = {e["name"]: e["unit"]
             for e in (c.per_layer if trace else c.end_to_end)}
    values = per_layer(c, results) if trace else end_to_end(c, results)
    device = {
        "platform": "gpu" if card else "cpu",
        "kind": torch.cuda.get_device_name(0) if card else "cpu",
        "count": c.chips,
        "memory_peak_bytes": max(r["peak_bytes"] for r in results)}
    line = {"correct": ok, "attempted": r0["calls"], "failed": failed,
            "metrics": {name: {"value": values[name], "unit": unit}
                        for name, unit in units.items() if name in values},
            "device": device}
    if trace and card:
        device["busy_s"] = statistics.fmean(r["busy_s"] for r in results)
        device["window_s"] = statistics.fmean(r["trace_window_s"]
                                              for r in results)
        line["breakdown"] = r0["breakdown"]
    line["check"] = table

    _log(f"{c.name} seed={args.seed} trace={args.trace} "
         f"mode={args.mode or c.config['mode']} card: "
         f"{card_line() if card else 'cpu'}; calls={r0['calls']} "
         f"window_s={r0['window_s']:.4f} setup_s={r0['setup_s']:.3f} "
         f"compile_s={sum(r0['compile_s'].values()):.3f} judged="
         f"{sum(len(r['judged']) for r in results)} "
         f"reference_s={r0['reference_s']:.3f}")
    _log("set-up reached (s after start): " + " ".join(
        f"{k}={v:.3f}" for k, v in r0["setup_phases"].items()))
    if trace:
        _log("traced windows (calls, s): " + "; ".join(
            f"{name} {w['calls']} {w['window_s']:.4f}"
            for name, w in zip(("host spans", "host operators",
                                "CUDA alone"), r0["trace_windows"])))
    if trace and card:
        _log("traced window's idle share, %: CUDA activity alone "
             + " ".join(f"{100.0 * (1.0 - r['busy_s'] / r['trace_window_s'])!r}"
                        for r in results)
             + "; with host operators "
             + " ".join(f"{r['idle_with_host_ops']!r}" for r in results))
    if not trace:
        calls_ms = sorted(1e3 * t for t in r0["call_s"])
        _log(f"call ms: min {calls_ms[0]:.4f} median "
             f"{statistics.median(calls_ms):.4f} max {calls_ms[-1]:.4f}")
    print(json.dumps(line), flush=True)
    for name, entry in table.items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
