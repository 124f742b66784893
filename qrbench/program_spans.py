"""The program's own spans (``tsqr_tpu_torch.utils.trace``), for the
per-layer metrics of source ``program_span`` that read them.

Importing this module opens the program's span collector.  The harness
loads a cell's metric readers only in a ``--trace 1`` run, after the
warm-up and right before window 0 (``loop.run_process``), and window 0
is the first to call the program after that: its calls, which run
without the profiler, are the first ``view.calls`` outermost ``ladder``
spans the collector holds (``closed_loop`` counts every call it makes).
The traced windows after it add their spans behind those.  A timed
``--trace 0`` run loads no reader, so no collector is open there.

A program without the module (or without its spans) leaves
``COLLECTOR`` None, or no ``ladder`` span to read: the readers then
return None.
"""

from __future__ import annotations

try:
    from tsqr_tpu_torch.utils import trace as _trace
except ImportError:
    _trace = None

COLLECTOR = _trace.collect() if _trace is not None else None


def outermost(spans, name: str) -> list:
    """The spans of ``name`` in ``spans`` with no ancestor of that name."""
    out = []
    for s in spans:
        p = s.parent
        while p is not None and COLLECTOR.spans[p].name != name:
            p = COLLECTOR.spans[p].parent
        if s.name == name and p is None:
            out.append(s)
    return out


def window_calls(view) -> list:
    """The outermost ``ladder`` spans of window 0's calls, or [] where
    the collector does not hold one a call."""
    if COLLECTOR is None or view.calls < 1:
        return []
    calls = outermost(COLLECTOR.spans, "ladder")[:view.calls]
    return calls if len(calls) == view.calls else []
