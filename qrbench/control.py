"""Readings for the limits of a cell's check: the program's judged numbers
over many seeds, and its control's over a few.

    python3 qrbench/control.py --workload NAME --seeds 1 2 ... \
        [--control-seeds 3] [--modes bf16x3_cor bf16]

For each seed, the cell's inputs at its own size go through the timed
entry as a run drives it (set-up, then one call on each input, one
caller) and ``reference.judge`` judges every output: first in the
configuration's mode (the sound runs: the lower reading of each number
is their largest), then, on the first ``--control-seeds`` seeds, in each
of ``--modes``, the program's own lower-precision paths (the control:
the upper reading is its smallest).  One JSON line per (mode, seed) on
stdout, then a summary line with those readings.  Several chips: one
process a chip, all readings in one group.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
    sys.path[0] = str(ROOT)


def readings(rank: int, world: int, cell, plan, device_type: str) -> list:
    """[(mode, seed, worst judged numbers, calls)] for each (mode, seed) of
    ``plan``, on this rank."""
    import torch

    from qrbench import loop
    device = (torch.device("cuda", rank if world > 1 else 0)
              if device_type == "cuda" else torch.device("cpu"))
    out = []
    for mode, seed in plan:
        res = loop.run_process(cell, seed, 0.0, False, device, time.time(),
                               rank, world, mode)
        worst = {}
        for numbers in res["judged"]:
            for name, v in numbers.items():
                if v is not None:
                    worst[name] = max(worst.get(name, v), v)
        out.append((mode, seed, worst, res["calls"]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--modes", nargs="*", default=["bf16x3_cor", "bf16"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--m", type=int, default=None, help="tests only")
    p.add_argument("--inputs", type=int, default=None, help="tests only")
    args = p.parse_args(argv)

    from qrbench import cell as cell_mod, ranks
    c = cell_mod.find(args.workload, ROOT)
    if args.m:
        c.config["m"] = args.m
    if args.inputs:
        c.config["inputs"] = args.inputs
    own = c.config["mode"]
    plan = [(own, s) for s in args.seeds] + [
        (md, s) for md in args.modes for s in args.seeds[:args.control_seeds]]
    if c.chips == 1:
        rows = readings(0, 1, c, plan, args.device)
    else:
        per_rank = ranks.launch(
            c.chips, readings, (c, plan, args.device),
            backend="nccl" if args.device == "cuda" else "gloo",
            timeout=3000.0)
        rows = []
        for i, (mode, seed, _, calls) in enumerate(per_rank[0]):
            worst = {}
            for rank_rows in per_rank:
                for name, v in rank_rows[i][2].items():
                    worst[name] = max(worst.get(name, v), v)
            rows.append((mode, seed, worst, calls))
    summary = {}
    for mode, seed, worst, calls in rows:
        print(json.dumps({"workload": c.name, "mode": mode, "seed": seed,
                          "calls": calls, "worst": worst}), flush=True)
        pick = max if mode == own else min
        acc = summary.setdefault(mode, {})
        for name, v in worst.items():
            acc[name] = pick(acc.get(name, v), v)
    print(json.dumps({"workload": c.name, "own_mode": own,
                      "lower_reading": summary.get(own, {}),
                      "control_upper_readings": {
                          md: v for md, v in summary.items() if md != own}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
