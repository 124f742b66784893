"""One run of a cell: set-up, the measured (or traced) window of a closed
loop with one caller, then the check against the plain reference.

:func:`run_process` is what one process does, alone or as one rank of a
group (``ranks.launch`` starts the group, one process a chip).  It

1. makes the cell's K inputs on the device from the seed
   (``generate.make_inputs``) and binds the configuration's entry;
2. draws from the seed the inputs whose outputs are judged (``JUDGED``
   of them) and warms up: one call on each of those, whose outputs it
   keeps, and one on another input, whose output it drops.  The first
   calls build the kernels (``ops/build/`` in the checkout) and create the
   library handles, and the allocator's cache then holds what the window
   needs: nothing is allocated from the device inside it;
3. runs the window: one call after another, round robin over the K
   inputs, each timed on the host clock from its start to its outputs
   being ready (``torch.cuda.synchronize``; on several ranks also an
   all-reduce of rank 0's decision to stop, which waits for every rank),
   until ``seconds`` have passed and every judged input has had a call.
   The last output on each judged input is kept for the check (the one
   before it is dropped once the new one is made), every other output is
   dropped after its call; the allocator's peak in the window above what
   was allocated at its start is the peak of one call beside the resident
   inputs and kept outputs;
4. or, traced (``--trace 1``), runs three bounded windows of at least
   one call and ``TRACE_SECONDS`` each, with spans around the functions
   the cell's per-layer metrics read: the first without the profiler,
   for the metrics of host spans and counters (the profiler's cost on
   every operation would swell a host-bound span) and the untraced time
   a call; the second under ``torch.profiler`` with host operators, for
   the device metrics that join device time to spans, and for the idle
   gaps' names; the third under ``torch.profiler`` with CUDA activity
   alone, which adds less host time to each launch, for the device-busy
   time and the metrics that set ``HOST_OPS = False``
   (``device.idle_share``);
5. frees the program's state and judges each kept output with
   ``reference.judge``, in blocks of rows, after the window and after
   the memory peak was read.

The benchmark never edits the program: the spans are wrappers put in
place of module attributes for the traced window only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time

import torch

from qrbench import cell as cell_mod, generate, reference
from qrbench import spans as spans_mod, tracing

WARMUP_CALLS = 2      # at least, on one input if there is only one
JUDGED = 2            # inputs a run judges, drawn from the seed
TRACE_SECONDS = 0.3
BUILD_COUNTER = "tsqr_tpu_torch.ops._build:BUILD_SECONDS"


@dataclasses.dataclass
class View:
    """What a per-layer metric reads: the traced window's device trace
    (None on the CPU), the spans, the traced calls, the cell, and the
    calls and seconds of the first window, which runs without the
    profiler."""

    trace: object
    spans: spans_mod.Recorder
    calls: int
    cell: cell_mod.Cell
    untraced: tuple[int, float]


class Group:
    """The collectives the harness itself needs on several ranks (plain
    ``torch.distributed``): one rank's decision shared, float64 sums and
    stacks for the reference.  ``None`` group on one process."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world, self.device = rank, world, device

    def decide(self, flag: bool) -> bool:
        """Rank 0's flag, on every rank; waits for every rank."""
        import torch.distributed as dist
        t = torch.tensor([int(flag and self.rank == 0)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        t = t.clone()
        dist.all_reduce(t)
        return t

    def stack(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)


def _sync(card: bool) -> None:
    if card:
        torch.cuda.synchronize()


def closed_loop(call, xs, seconds: float, min_calls: int, card: bool,
                keep, outs: dict, group: Group | None = None,
                order=None) -> dict:
    """The window: calls round robin over ``xs`` (or over the indices of
    ``order``) until ``seconds`` have passed and ``min_calls`` are done.
    ``outs`` holds the last output on each input of ``keep``, from an
    earlier window on; a kept output is replaced only once the next one
    on its input is made, so what is resident stays as it was at the
    start and the window's peak above it is the largest call's own.  The
    allocator's statistics are read once before and once after the
    window (each read builds a dict of every statistic: inside the loop
    it would add host time and garbage to every call)."""
    order = list(range(len(xs))) if order is None else list(order)
    call_s: list[float] = []
    if card:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    i = 0
    started = time.time()
    t_start = t1 = time.perf_counter()
    while True:
        j = order[i % len(order)]
        t0 = time.perf_counter()
        out = call(xs[j])
        _sync(card)
        stop = (time.perf_counter() - t_start >= seconds
                and i + 1 >= min_calls)
        if group is not None:
            stop = group.decide(stop)
        t1 = time.perf_counter()
        if j in keep:
            outs[j] = out
        del out
        call_s.append(t1 - t0)
        i += 1
        if stop:
            break
    peak = torch.cuda.max_memory_allocated() if card else 0
    return {"calls": i, "window_s": t1 - t_start, "call_s": call_s,
            "over_bytes": peak - base if card else 0, "peak_bytes": peak,
            "started": started}


@contextlib.contextmanager
def settled():
    """Collect, and freeze what is left, for the window inside: a pass of
    the collector over the set-up's objects (and a parsed trace's) then
    cannot fall inside it; the program's own garbage is collected as
    ever."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def _bind(cell: cell_mod.Cell, device: torch.device, mode: str | None):
    """The timed call: the configuration's entry with its arguments (and
    the mesh it builds, on several ranks)."""
    cfg = cell.config
    entry = cell_mod.resolve(cfg["entry"])
    kwargs = dict(cfg.get("kwargs", {}))
    kwargs["mode"] = mode or cfg["mode"]
    kwargs["device"] = device.type
    if cfg.get("mesh"):
        mesh = cell_mod.resolve(cfg["mesh"])()
        return lambda x: entry(x, mesh, **kwargs)
    return lambda x: entry(x, **kwargs)


def run_process(cell: cell_mod.Cell, seed: int, seconds: float, trace: bool,
                device: torch.device, t_process: float, rank: int = 0,
                world: int = 1, mode: str | None = None,
                prepare: str | None = None) -> dict:
    """One process's run (one rank's, on several chips); every number it
    measured, the judged numbers, and the per-layer values if traced.
    ``mode`` runs another of the program's modes (the control);
    ``prepare`` names a function called first (the fault tests')."""
    if prepare:
        cell_mod.resolve(prepare)()
    card = device.type == "cuda"
    group = Group(rank, world, device) if world > 1 else None
    cfg = cell.config
    k = int(cfg["inputs"])
    phases = {"start": time.time() - t_process}
    xs, info = generate.make_inputs(cell.mix, cell.m, cell.n, k, seed,
                                    device, rank, world)
    _sync(card)
    phases["inputs"] = time.time() - t_process
    call = _bind(cell, device, mode)
    keep = generate.judged_inputs(k, min(JUDGED, k), seed)
    warm = keep + [j for j in range(k) if j not in keep][:1]
    warm += [keep[0]] * (WARMUP_CALLS - len(warm))
    outs: dict[int, object] = {}
    closed_loop(call, xs, 0.0, len(warm), card, keep, outs, group, warm)
    phases["warmup"] = time.time() - t_process
    if group is not None:
        group.decide(True)
    setup_peak = torch.cuda.max_memory_allocated() if card else 0
    result = {"rank": rank, "setup_phases": phases}
    if trace:
        # each metric's window: 0 host spans, no profiler; 1 the profiler
        # with host operators; 2 the profiler with CUDA activity alone
        readers = {}
        for e in cell.per_layer:
            mod = cell_mod.load_metric(e["name"])
            readers[e["name"]] = (mod, 0 if e["source"] != "device_trace"
                                  else 1 if getattr(mod, "HOST_OPS", True)
                                  else 2)
        targets = [{t for mod, w in readers.values() if w == i
                    for t in mod.SPANS} for i in range(3)]
        # round robin from a judged input, so one is called in each
        order = [(keep[0] + i) % k for i in range(k)]
        views, wins, traces = [], [], []
        for i in range(3):
            with settled(), contextlib.ExitStack() as stack:
                rec = stack.enter_context(spans_mod.Recorder(targets[i]))
                box = (stack.enter_context(tracing.record(card, i == 1))
                       if i else [None])
                wins.append(closed_loop(call, xs, TRACE_SECONDS, 1, card,
                                        keep, outs, group, order))
            traces.append(box[0] if card else None)
            views.append(View(traces[i], rec, wins[i]["calls"], cell,
                              (wins[0]["calls"], wins[0]["window_s"])))
        result["layer"] = {}
        for name, (mod, i) in readers.items():
            value = mod.read(views[i])
            if value is not None and math.isfinite(value):
                result["layer"][name] = float(value)
        result["trace_windows"] = [{"calls": w["calls"],
                                    "window_s": w["window_s"]} for w in wins]
        win = dict(wins[-1])
        win["calls"] = sum(w["calls"] for w in wins)
        win["peak_bytes"] = max(w["peak_bytes"] for w in wins)
        win["over_bytes"] = max(w["over_bytes"] for w in wins)
        if card:
            host_ops, bare = traces[1], traces[2]
            result["busy_s"] = bare.busy_s()
            result["trace_window_s"] = bare.window_s
            result["idle_with_host_ops"] = 100.0 * (
                1.0 - host_ops.busy_s() / host_ops.window_s)
            result["breakdown"] = {"device_ops": bare.top_ops(),
                                   "idle_gaps": host_ops.idle_gaps()}
        del traces, views, box, rec
    else:
        with settled():
            win = closed_loop(call, xs, seconds, max(keep) + 1, card, keep,
                              outs, group)
    result.update(win)
    # set-up ends where the first window starts, the collector's pass in it
    result["setup_s"] = (wins[0] if trace else win)["started"] - t_process
    result["peak_bytes"] = max(setup_peak, win["peak_bytes"])
    result["input_bytes"] = xs[0].numel() * xs[0].element_size()
    result["compile_s"] = dict(cell_mod.resolve(BUILD_COUNTER))

    # the program's state goes before the reference runs
    del call
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    kw = {}
    if group is not None:
        kw = {"reduce": group.sum, "gather": group.stack}
    judged = []
    t_ref = time.perf_counter()
    for j in sorted(outs):
        q, r = outs.pop(j)[:2]
        judged.append(reference.judge(xs[j], q, r,
                                      info[j]["zero_columns"], **kw))
        del q, r
    result["judged"] = judged
    result["reference_s"] = time.perf_counter() - t_ref
    return result


FORBIDDEN = ("jax", "jaxlib", "flax", "tsqr_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``tsqr_tpu_torch`` is not ``tsqr_tpu``)."""
    import sys
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def rank_run(rank: int, world: int, cell: cell_mod.Cell, seed: int,
             seconds: float, trace: bool, t_process: float,
             mode: str | None, device_type: str,
             prepare: str | None = None) -> dict:
    """One rank of a run on several chips (``ranks.launch``'s target)."""
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    result = run_process(cell, seed, seconds, trace, device, t_process,
                         rank, world, mode, prepare)
    result["forbidden"] = forbidden_modules()
    return result
