"""Device timing with CUDA events.

Each repetition is bracketed by two events on the current stream; the
result is the list of per-repetition milliseconds after ``warmup``
unmeasured calls.  There is no CPU path: a time is a device time.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def time_cuda(fn: Callable[[], object], reps: int = 5,
              warmup: int = 2) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``fn()`` on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda measures on a CUDA device; none found")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn: Callable[[], object], reps: int = 5,
              warmup: int = 2) -> float:
    return statistics.median(time_cuda(fn, reps, warmup))


def graph_ms(fn: Callable[[], object], calls: int = 20, reps: int = 5) -> float:
    """Median device milliseconds of one ``fn()`` with the host taken out:
    ``calls`` calls captured in one CUDA graph, the graph replayed
    ``reps`` times between events.  For kernels of a few microseconds,
    whose single-call time is mostly the host's launch."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_ms measures on a CUDA device; none found")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
