"""Phase breakdowns and traces of BlockQR and the TSQR tree.

Counterpart of ``tsqr_tpu/harness/profile.py`` (the reference's
PROFILE_BREAKDOWN and MEASURE_QR_TIME switches).  Each breakdown times
real calls against the same calls with one phase taken out, by
``utils/timing.time_fn_amortized`` (CUDA events on the card):
:func:`blockqr_breakdown` through BlockQR's ``_ablate`` hook,
:func:`tsqr_phase_split` through the tree's ``want_q=False``.
:func:`trace` records a ``torch.profiler`` trace of a region, writes it
as a Chrome trace and sums its CUDA kernels: their count, the
device-busy share and the longest kernels by total time.

    python -m tsqr_tpu_torch.harness.main profile [--quick]
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import IO, Iterator, Sequence

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import blockqr, tsqr as tsqr_mod
from tsqr_tpu_torch.harness import accuracy
from tsqr_tpu_torch.utils import device as _device
from tsqr_tpu_torch.utils import timing

Activity = torch.profiler.ProfilerActivity


def _uniform(m: int, n: int, device, what: str) -> torch.Tensor:
    dev = _device.resolve(device, what)
    gen = torch.Generator(device=dev).manual_seed(0)
    return accuracy.uniform(m, n, gen, device=dev)


def blockqr_breakdown(m: int, n: int, mode: str = "fp32",
                      panel_width: int = 128, reorth: bool = False,
                      out: IO = sys.stderr, device=None, **qr_kw) -> dict:
    """Panel-QR and trailing-GEMM shares of one BlockQR call, measured by
    ablation: the full call, the call with the panel factorizations
    replaced by (A', I) (``_ablate="no_panel"``) and the call without the
    trailing projections (``_ablate="no_project"``) are each timed;
    a phase's time is the full time less the time without it.
    ``other_s`` is the rest (fix-up products, casts).  Runs on the card
    unless ``device="cpu"``."""
    policy = modes.resolve(mode)
    a = _uniform(m, n, device, "blockqr_breakdown")

    def run(ablate):
        return timing.time_fn_amortized(
            lambda x: blockqr.qr(x, policy, reorth=reorth,
                                 panel_width=panel_width, _ablate=ablate,
                                 device=x.device, **qr_kw),
            a, loops=4, reps=2)

    t_total = run(None)
    t_panel = max(t_total - run("no_panel"), 0.0)
    t_gemm = max(t_total - run("no_project"), 0.0)
    result = {
        "total_s": t_total,
        "tsqr_s": t_panel,
        "gemm_s": t_gemm,
        "other_s": t_total - t_panel - t_gemm,
        "tsqr_pct": 100 * t_panel / t_total,
        "gemm_pct": 100 * t_gemm / t_total,
    }
    print(f"# blockqr breakdown m={m} n={n} mode={policy.name}: "
          f"total {t_total*1e3:.2f} ms, panel-QR {result['tsqr_pct']:.0f}%, "
          f"trailing-GEMM {result['gemm_pct']:.0f}% (measured by real-"
          f"program ablation)", file=out, flush=True)
    return result


def tsqr_phase_split(m: int, n: int, mode: str = "fp32",
                     out: IO = sys.stderr, device=None, **tsqr_kw) -> dict:
    """Compute-R and compute-Q shares of one TSQR call: the full tree
    against the forward tree alone (``want_q=False``, no Q
    reconstruction); compute-Q = t(full) - t(R only).  Runs on the card
    unless ``device="cpu"``."""
    policy = modes.resolve(mode)
    a = _uniform(m, n, device, "tsqr_phase_split")

    def run(want_q):
        return timing.time_fn_amortized(
            lambda x: tsqr_mod.tsqr(x, policy, want_q=want_q,
                                    device=x.device, **tsqr_kw),
            a, loops=4, reps=3)

    t_full = run(True)
    t_r = run(False)
    t_q = max(t_full - t_r, 0.0)
    result = {"total_s": t_full, "compute_r_s": t_r, "compute_q_s": t_q,
              "r_pct": 100 * t_r / t_full, "q_pct": 100 * t_q / t_full}
    print(f"# tsqr phase split m={m} n={n} mode={policy.name}: "
          f"total {t_full*1e3:.2f} ms, compute-R {t_r*1e3:.2f} ms "
          f"({result['r_pct']:.0f}%), compute-Q {t_q*1e3:.2f} ms "
          f"({result['q_pct']:.0f}%)", file=out, flush=True)
    return result


def _union_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


@dataclasses.dataclass
class Trace:
    """What :func:`trace` recorded.  ``path`` (the Chrome trace in
    ``logdir``), ``kernels`` ((name, start_us, end_us) of every CUDA
    kernel) and ``span_us`` (the first and last event of the trace) are
    filled when the region ends."""

    logdir: str
    path: str = ""
    kernels: list[tuple[str, float, float]] = dataclasses.field(
        default_factory=list)
    span_us: tuple[float, float] = (0.0, 0.0)

    def summary(self, top: int = 3) -> dict:
        """Kernel count, wall and busy ms, the device-busy share (the
        union of the kernel intervals over the wall time from the first to
        the last event) and the ``top`` kernels by total time."""
        wall = self.span_us[1] - self.span_us[0]
        busy = _union_us([(s, e) for _, s, e in self.kernels])
        by_name: dict[str, list] = {}
        for name, s, e in self.kernels:
            acc = by_name.setdefault(name, [0.0, 0])
            acc[0] += e - s
            acc[1] += 1
        longest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        return {"kernels": len(self.kernels), "wall_ms": wall / 1e3,
                "busy_ms": busy / 1e3,
                "busy_share": busy / wall if wall > 0 else 0.0,
                "top": [{"name": name, "total_ms": t / 1e3, "calls": c}
                        for name, (t, c) in longest]}

    def _read(self) -> None:
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        spans = [(ev.get("cat"), ev["name"], float(ev["ts"]),
                  float(ev["ts"]) + float(ev.get("dur", 0)))
                 for ev in events
                 if ev.get("ph") == "X" and ev.get("cat") != "Trace"]
        if spans:
            self.span_us = (min(s for _, _, s, _ in spans),
                            max(e for _, _, _, e in spans))
        self.kernels = [(name, s, e) for cat, name, s, e in spans
                        if cat == "kernel"]


@contextlib.contextmanager
def trace(logdir: str | None = None,
          activities: Sequence[Activity] | None = None) -> Iterator[Trace]:
    """Record a ``torch.profiler`` trace of the region; on exit write it
    as a Chrome trace into ``logdir`` (default ``tsqr_trace`` in the
    temporary directory) and read its kernels into the yielded
    :class:`Trace`.

    activities: default CPU, and CUDA where a card is available.  Raises
    ``RuntimeError`` when CUDA was requested and the trace holds no CUDA
    kernel: an empty trace is no measurement."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "tsqr_trace")
    if activities is None:
        activities = [Activity.CPU] + (
            [Activity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    rec = Trace(logdir)
    with torch.profiler.profile(activities=list(activities)) as prof:
        yield rec
        if Activity.CUDA in activities and torch.cuda.is_available():
            torch.cuda.synchronize()
    rec.path = os.path.join(logdir, f"trace_{os.getpid()}_"
                                    f"{time.time_ns()}.json")
    prof.export_chrome_trace(rec.path)
    rec._read()
    if Activity.CUDA in activities and not rec.kernels:
        raise RuntimeError(f"trace requested CUDA activity and recorded no "
                           f"CUDA kernel ({rec.path})")
