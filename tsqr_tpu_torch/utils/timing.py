"""Device timing with CUDA events, and the reference's timers over it.

``time_cuda`` brackets each repetition by two events on the current
stream and returns the per-repetition milliseconds after ``warmup``
unmeasured calls; it has no CPU path: a time is a device time.

``time_fn``, ``time_fn_amortized``, ``time_fn_distinct`` and
``time_fn_amortized_auto`` keep the names, arguments and return values
(seconds per call) of ``tsqr_tpu/utils/timing.py``.  Where their input
lies on the card they time with ``time_cuda``; on the CPU with
``time.perf_counter``, where eager PyTorch has finished a call when it
returns.  The reference chains N calls inside one jitted program and
subtracts a null chain to take a tunnelled dispatch out of the time;
eager PyTorch has no such program.  Here the N calls run back to back
between two events on the stream, the host's launches included, which
is what a caller of the eager entry points pays.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Sequence

import torch

# A window shorter than this is below what the events resolve (about
# 0.5 us each, CUDA's documentation) with margin: resolution_nan gives NaN.
_RESOLUTION_S = 5e-5


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


def _on_card(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_on_card(v) for v in x)
    return False


def windows_ms(run: Callable[[], object], card: bool, reps: int,
               warmup: int = 1) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``run()`` after
    ``warmup``: CUDA events on the card (:func:`time_cuda`), else
    ``time.perf_counter``."""
    if card:
        return time_cuda(run, reps=reps, warmup=warmup)
    for _ in range(warmup):
        run()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _best_seconds(run: Callable[[], object], card: bool, reps: int,
                  warmup: int = 1) -> float:
    """Least seconds of ``reps`` calls of ``run()`` after ``warmup``."""
    return min(windows_ms(run, card, reps, warmup)) / 1e3


def _per_call(window: float, calls: int, resolution_nan: bool) -> float:
    if resolution_nan and window < _RESOLUTION_S:
        return float("nan")
    return max(window / calls, 1e-9)


def time_fn(fn: Callable, inputs: Sequence, iters: int = 4,
            warmup: int = 2) -> float:
    """Least seconds of one call ``fn(input)`` over ``iters`` calls that
    rotate through ``inputs``, after ``warmup`` calls."""
    n_in = len(inputs)
    card = _on_card(inputs[0])
    for i in range(warmup):
        fn(inputs[i % n_in])
    return min(_best_seconds(lambda x=inputs[i % n_in]: fn(x), card,
                             reps=1, warmup=0) for i in range(iters))


def time_fn_amortized(fn: Callable, x, loops: int = 10, reps: int = 3,
                      resolution_nan: bool = False) -> float:
    """Seconds per call of ``fn(x)``: the best of ``reps`` windows of
    ``loops`` back-to-back calls, over ``loops``, after one warm-up
    window.  With ``resolution_nan`` a window below the timer's
    resolution gives NaN instead of a number."""
    def window():
        for _ in range(loops):
            fn(x)
    return _per_call(_best_seconds(window, _on_card(x), reps), loops,
                     resolution_nan)


def time_fn_distinct(fn: Callable, xs: Sequence, reps: int = 3,
                     serialize: bool = True,
                     resolution_nan: bool = False) -> float:
    """Seconds per call of ``fn`` over K distinct resident inputs: the
    best of ``reps`` windows of one call on each of ``xs``, over K.

    All K inputs stay resident; size K so that K inputs and one call's
    working set fit the card.  ``serialize`` is kept for the reference's
    callers: eager calls on one stream always run one after another."""
    del serialize

    def window():
        for x in xs:
            fn(x)
    return _per_call(_best_seconds(window, _on_card(xs[0]), reps), len(xs),
                     resolution_nan)


def time_fn_amortized_auto(fn: Callable, x, reps: int = 3,
                           min_active: float = 0.15,
                           max_loops: int = 4096,
                           resolution_nan: bool = False) -> tuple[float, int]:
    """``time_fn_amortized`` with ``loops`` scaled to the call's speed: a
    4-call probe estimates the time of a call, then ``loops`` is chosen
    so that a window lasts at least ``min_active`` seconds (at most
    ``max_loops`` calls).  Returns (seconds_per_call, loops_used)."""
    probe_loops = 4
    t_est = time_fn_amortized(fn, x, loops=probe_loops, reps=2,
                              resolution_nan=resolution_nan)
    if t_est != t_est:  # probe below resolution: assume microsecond-class
        t_est = 1e-6
    loops = max(probe_loops,
                min(max_loops, int(-(-min_active // max(t_est, 1e-6)))))
    return time_fn_amortized(fn, x, loops=loops, reps=reps,
                             resolution_nan=resolution_nan), loops
