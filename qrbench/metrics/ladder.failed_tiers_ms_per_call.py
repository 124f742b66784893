"""ladder.failed_tiers_ms_per_call: host time the ladder spends before
tier 4 on the calls that end there, in window 0 (no profiler): the start
of ``ladder.tier4`` less the start of its outermost ``ladder`` span,
averaged over those calls (``qrbench/program_spans.py``).  It is the cost
of the tiers that failed: tier 0's Gram and bound, tiers 2 and 3 with
their gates."""

from qrbench import program_spans as ps

SPANS = []


def read(view):
    waste = []
    for c in ps.window_calls(view):
        if c.attrs.get("tier") != 4:
            continue
        t4 = [s for s in ps.COLLECTOR.descendants(c.sid)
              if s.name == "ladder.tier4"]
        if t4:
            waste.append(t4[0].t0 - c.t0)
    if not waste:
        return None
    return sum(waste) / len(waste) / 1e6
