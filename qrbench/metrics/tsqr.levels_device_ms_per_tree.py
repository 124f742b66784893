"""tsqr.levels_device_ms_per_tree: the device time of a TSQR tree's inner
levels.  The device operations whose launch falls inside the host
interval of one of the program's ``tsqr.level`` spans (``core/tsqr.py``;
under ``torch.profiler`` a ``user_annotation`` of that name) are kept;
their union inside the traced window is divided by the trees, the
outermost ``tsqr.tree`` annotations that start in the window.  None where
the trace holds no such span or no tree: a program without the spans."""

import bisect

SPANS = []
PHASE = "tsqr.level"
TREE = "tsqr.tree"


def _outermost(intervals):
    """The intervals that lie inside no other of the list."""
    out = []
    for s, e in sorted(intervals, key=lambda x: (x[0], -x[1])):
        if not out or s >= out[-1][1]:
            out.append((s, e))
    return out


def device_ms_per_tree(view, phase: str):
    """The union of the device time launched inside the ``phase``
    annotations, in ms, over the trees of the traced window."""
    tr = view.trace
    if tr is None:
        return None
    w0, w1 = tr.window
    trees = [(s, e) for s, e, name in tr.host
             if name == TREE and w0 <= s < w1]
    phases = _outermost([(s, e) for s, e, name in tr.host if name == phase])
    if not trees or not phases:
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
    return 1e3 * tr.busy_s(ops) / len(_outermost(trees))


def read(view):
    return device_ms_per_tree(view, PHASE)
