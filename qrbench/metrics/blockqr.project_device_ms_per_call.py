"""blockqr.project_device_ms_per_call: the device time of BlockQR's
projections against the Q built so far.  The device operations whose
launch falls inside the host interval of one of the program's
``blockqr.project`` spans (``core/blockqr.py``: each CGS pass's two
products against Q; under ``torch.profiler`` a ``user_annotation`` of
that name) are kept; their union inside the traced window is divided by
the calls, the outermost ``blockqr`` annotations that start in the
window.  None where the trace holds no such span or no call: a program
without the spans."""

import bisect

from qrbench import cell as _cell

SPANS = []
PHASE = "blockqr.project"
CALL = "blockqr"

_outermost = _cell.load_metric("tsqr.levels_device_ms_per_tree")._outermost


def device_ms_per_call(view, phase: str):
    """The union of the device time launched inside the ``phase``
    annotations, in ms, over the BlockQR calls of the traced window."""
    tr = view.trace
    if tr is None:
        return None
    w0, w1 = tr.window
    calls = [(s, e) for s, e in _outermost(
        [(s, e) for s, e, name in tr.host if name == CALL]) if w0 <= s < w1]
    phases = _outermost([(s, e) for s, e, name in tr.host if name == phase])
    if not calls or not phases:
        return None
    starts = [s for s, _ in phases]
    ops = []
    for op in tr.ops:
        if op.launch is None:
            continue
        i = bisect.bisect_right(starts, op.launch) - 1
        if i >= 0 and op.launch <= phases[i][1]:
            ops.append(op)
    if not ops:
        return None
    return 1e3 * tr.busy_s(ops) / len(calls)


def read(view):
    return device_ms_per_call(view, PHASE)
