"""The traced run's device trace: record a bounded window with
``torch.profiler``, then read it.

:func:`record` runs a region under the profiler inside a
``qrbench.window`` annotation, writes the Chrome trace to a file under
the temporary directory, reads it into a :class:`Trace` and deletes the
file.  A first, empty session starts CUPTI, so that its start-up cost
falls outside the window.  With ``host_ops`` (the default) the profiler
records CPU activity too: every operator on the host, with its own cost
on each, which the spans' device attribution and the idle gaps' names
need.  Without it only CUDA activity is recorded (the device operations
and the runtime calls that launched them), so the host runs at nearly
its untraced pace: the device-busy share is read there.  Such a trace
may hold no annotation; its window then runs from the first runtime
call to the last event.

:class:`Trace` holds the window's interval, the device operations
(kernels, copies, fills) with the host time of the runtime call that
launched each (joined by the trace's correlation ids), the spans'
annotations (``spans.label``) and the main thread's host events.  From
these it gives the device-busy time (the union of the device
operations' intervals inside the window), the operations launched inside
a set of spans, the operations that took most time and the idle gaps by
what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

import torch

from qrbench import arith, spans as spans_mod

WINDOW = "qrbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS
NAME_CHARS = 160   # a kernel's template name can run to a thousand


@dataclasses.dataclass
class Op:
    name: str
    start: float     # us, the trace's clock
    end: float
    launch: float | None   # us, host time of the launching call


@dataclasses.dataclass
class Trace:
    window: tuple[float, float] = (0.0, 0.0)
    ops: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)  # sid -> (key, s, e)
    host: list = dataclasses.field(default_factory=list)   # (s, e, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _in_window(self, ops) -> list[tuple[float, float]]:
        w0, w1 = self.window
        return [(max(o.start, w0), min(o.end, w1)) for o in ops
                if o.end > w0 and o.start < w1]

    def busy_s(self, ops=None) -> float:
        """Seconds of the window in which some device operation ran."""
        ops = self.ops if ops is None else ops
        return arith.union_length(self._in_window(ops)) / 1e6

    def ops_in(self, sids) -> dict[int, list[Op]]:
        """The device operations launched inside each span of ``sids``
        (spans that do not nest one another): {sid: [Op]}."""
        bounds = sorted((self.spans[s][1], self.spans[s][2], s)
                        for s in sids if s in self.spans)
        starts = [b[0] for b in bounds]
        out: dict[int, list[Op]] = {s: [] for _, _, s in bounds}
        for op in self.ops:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= bounds[i][1]:
                out[bounds[i][2]].append(op)
        return out

    def top_ops(self, count: int = 10) -> list[list]:
        """[[name, seconds]] of the device operations that took most time
        in the window, summed by name."""
        by_name: dict[str, float] = {}
        for op in self.ops:
            if op.end > self.window[0] and op.start < self.window[1]:
                by_name[op.name] = (by_name.get(op.name, 0.0)
                                    + (op.end - op.start) / 1e6)
        return _top(by_name, count)

    def idle_gaps(self, count: int = 10) -> list[list]:
        """[[host activity, seconds]]: the window's idle time, each gap
        between device operations named by the innermost host event that
        covers its middle ("python" where none does), summed by name."""
        w0, w1 = self.window
        busy = sorted(self._in_window(self.ops))
        gaps, reach = [], w0
        for s, e in busy:
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
        if w1 > reach:
            gaps.append((reach, w1))
        host = sorted(self.host)
        by_name: dict[str, float] = {}
        stack: list[tuple[float, float, str]] = []
        j = 0
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            while j < len(host) and host[j][0] <= mid:
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            inner = next((h for h in reversed(stack) if h[1] >= mid), None)
            name = _plain_name(inner[2]) if inner else "python"
            by_name[name] = by_name.get(name, 0.0) + (g1 - g0) / 1e6
        return _top(by_name, count)


def _top(by_name: dict, count: int) -> list[list]:
    """The ``count`` largest entries, names cut to ``NAME_CHARS``."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
    return [[k[:NAME_CHARS], v] for k, v in top]


def _plain_name(name: str) -> str:
    parsed = spans_mod.parse_label(name)
    return parsed[0] if parsed else name


def read(events: list) -> Trace:
    """A :class:`Trace` from a Chrome trace's ``traceEvents``."""
    tr = Trace()
    launches: dict[int, float] = {}
    device = []
    window_tid = None
    host = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts = float(ev["ts"])
        end = ts + float(ev.get("dur", 0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((name, ts, end, args.get("correlation")))
            continue
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[int(args["correlation"])] = ts
        if cat == "user_annotation":
            if name == WINDOW:
                tr.window = (ts, end)
                window_tid = ev.get("tid")
                continue
            parsed = spans_mod.parse_label(name)
            if parsed is not None:
                tr.spans[parsed[1]] = (parsed[0], ts, end)
        if cat in HOST_CATS:
            host.append((ts, end, name, ev.get("tid")))
    tr.ops = [Op(name, s, e, launches.get(int(c)) if c is not None else None)
              for name, s, e, c in device]
    if window_tid is None and launches:   # CUDA activity alone
        tr.window = (min(launches.values()),
                     max([e for _, e, _, _ in host]
                         + [e for _, _, e, _ in device]))
    tr.host = [(s, e, name) for s, e, name, tid in host if tid == window_tid]
    return tr


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def record(card: bool, host_ops: bool = True):
    """``with record(card) as box: <region>``; afterwards ``box[0]`` is the
    region's :class:`Trace`.  ``host_ops=False`` records CUDA activity
    alone (on a card)."""
    Activity = torch.profiler.ProfilerActivity
    activities = ([Activity.CPU] if host_ops or not card else []) \
        + ([Activity.CUDA] if card else [])
    if card:
        with torch.profiler.profile(activities=activities):
            torch.zeros(1, device="cuda").add_(1)
            _sync()
    box: list[Trace] = []
    fd, path = tempfile.mkstemp(prefix="qrbench_trace_", suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                yield box
                _sync()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        box.append(read(events))
    finally:
        os.remove(path)
