"""stream.self_us_per_call: the stream wrapper's own host time a call of
it, in window 0 (no profiler): each outermost ``stream`` span inside the
window's ``ladder`` spans (an entry of ``ops/gram_stream.stream`` or
``gram_stream``), less the union of its ``stream.launch`` descendants
(the ctypes launches of the kernels and of the reduction stage),
averaged over those spans: the wrapper's checks, casts and
allocations."""

from qrbench import program_spans as ps

SPANS = []


def read(view):
    col = ps.COLLECTOR
    spans = [s for c in ps.window_calls(view)
             for s in ps.outermost(col.descendants(c.sid), "stream")]
    if not spans:
        return None
    return sum(col.self_ns(s.sid, ("stream.launch",)) for s in spans) \
        / len(spans) / 1e3
