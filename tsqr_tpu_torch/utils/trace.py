"""Spans and counters of ``tsqr_tpu_torch``: where a call's host time goes,
and what it launched.

**Spans.** ``with trace.span(name, **attrs):`` marks a region of the host's
work.  A span is off unless a collector is open or ``torch.profiler`` is
recording; off, :func:`span` returns a shared no-op after those two checks
(no annotation is built and no clock is read).  The program's spans, at
its layer boundaries:

- ``ladder``: one ``qr_auto_fused`` call (attrs m, n, mode, and tier, the
  tier it ended at); ``ladder.tier0`` .. ``ladder.tier4``: each tier the
  call entered (tier 0 is the Gram, its Cholesky and the kappa^2 bound);
- ``sync``: a host read of a device value (attr site), where the host
  waits for the device;
- ``stream``: an entry of ``ops.gram_stream.stream`` or ``gram_stream``
  (the checks, casts and allocations around the launches);
  ``stream.launch``: one ctypes launch of a stream kernel or of its
  reduction stage;
- ``blockqr``: one ``core.blockqr.qr`` call; inside it, for each panel
  step (``core.blockqr._panel_step``, and the one panel of n <= the
  panel width), ``blockqr.project`` (one CGS pass's two products
  against the Q built so far, attrs c0: the panel's first column, w:
  its width, pass: 1, or 2 for CGS2's second) and ``blockqr.panel`` (one
  factorization of the panel, the same attrs; a ``tsqr.tree`` inside);
- ``tsqr.tree``: one ``core.tsqr.tsqr`` call; inside it ``tsqr.leaves``
  (the leaves' batched QR), ``tsqr.level`` (one level of inner nodes,
  attrs batch: the nodes, fanin: the node's stacked R factors, impl:
  its batched QR, "pallas_sb" for the panel kernel or "jnp" for the
  blocked Householder) and ``tsqr.q_build`` (Q down the tree);
- ``panel``: one ``ops.panel_kernel.panel_qr_batched`` call, on the card
  or through its plain version (attrs kernel: "panel_qr" for n <= 128,
  "panel_wide" past it; batch, L, n: the (batch, L, n) tiles); the
  leaves' and each level's batched QR on the panel route.

**Collecting.** ::

    from tsqr_tpu_torch.utils import trace
    with trace.collect() as col:
        q, r = tsqr_tpu_torch.qr_auto_fused(a, "bf16x6_cor")
    col.write("spans.jsonl")

keeps every span in memory, in the order they started: its name, start
and end on ``time.perf_counter_ns()``, its parent span, the id of its
outermost span (one per public call) and its attrs.  :meth:`Collector.write`
writes one JSON object a line, with start and end mapped onto the wall
clock (``time.time_ns()``), which is the clock of a ``torch.profiler``
Chrome trace (``baseTimeNanoseconds`` + ``ts`` microseconds).  One
collector is open at a time; spans of one thread.

**In a profiler trace.** While ``torch.profiler`` records (for instance
``harness.main profile``, or any ``torch.profiler.profile`` around a
call), each span also opens ``torch.profiler.record_function(name)``: the
spans appear as ``user_annotation`` events of the trace, on the
profiler's own clock, and a device operation belongs to the span whose
interval launched it.

**Counters** are always on: ``trace.count(name, k)`` adds, and
``trace.counts(prefix)`` reads them (names without the prefix):

- ``launches.<kernel>``: kernel launches, counted where each kernel is
  launched (``stream_gram``, ``stream_gram_alias_q`` (the launches that
  write Q over A), ``stream_gram_reduce``, ``stream_wide_dot``,
  ``stream_wide_gram``, ``stream_wide_dot_fp32``, ``stream_wide_gram_fp32``,
  ``stream_wide_store``, ``stream_wide_split_r``, ``stream_wide_split_x``,
  ``panel_qr``, ``panel_qr_wide`` (calls, each its launch sequence),
  ``split_mm``, ``read_reduce``, ``read_reduce_sum``, ``copy``);
- ``panel_wide.outer_applies``: the 64-column reflector applies that
  ``panel_wide.cu``'s launch sequence reports it issued, added with each
  call's ``launches.panel_qr_wide`` (7 a call at n = 256; a call whose
  counts differ from ``panel_kernel.wide_kernel_launches`` and
  ``wide_outer_applies`` raises);
- ``blockqr.panels``, ``blockqr.project``: BlockQR's panel steps, one
  count a step, and its projection products, one count a product (at
  (2^15, 2^13) with CGS2: 64 and 252 a call);
- ``ladder.tier<k>``: ``qr_auto_fused`` calls that ended at tier k, the
  ladder's histogram: a shift toward tier 4 is inputs losing rank;
- ``tsqr.inner.kernel``, ``tsqr.inner.householder``: levels of a TSQR
  tree's inner nodes, one count a level, by route: the panel kernel (its
  plain version on a CPU tensor) or the blocked Householder;
- ``tsqr.q_build.kernel``, ``tsqr.q_build.mm``: products of a TSQR
  tree's Q build, one count a product, by route: ``split_mm.cu`` (the
  policy's product one of the split modes' own, on the card) or the
  policy's product itself;
- ``sync.<site>``: host reads of device values at each site.
"""

from __future__ import annotations

import collections
import itertools
import json
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_counts: dict[str, int] = {}
_collector: Collector | None = None


class Collector:
    """The spans recorded while it is open, in the order they started;
    ``wall_ns`` and ``perf_ns`` are one reading of both clocks, taken as it
    opened."""

    def __init__(self):
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self.wall_ns, self.perf_ns = time.time_ns(), time.perf_counter_ns()

    def wall(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` time on the wall clock (``time_ns``)."""
        return t_ns - self.perf_ns + self.wall_ns

    def descendants(self, sid: int) -> list[Span]:
        """The spans opened inside span ``sid``: in start order they follow
        it, one block."""
        out = []
        for rec in self.spans[sid + 1:]:
            p = rec.parent
            while p is not None and p > sid:
                p = self.spans[p].parent
            if p != sid:
                break
            out.append(rec)
        return out

    def self_ns(self, sid: int, names=None) -> int:
        """Span ``sid``'s length less the part of it that its descendants
        named in ``names`` cover (its children where ``names`` is None):
        the layer's self time."""
        s = self.spans[sid]
        inner = sorted((d.t0, d.t1) for d in self.descendants(sid)
                       if (d.parent == sid if names is None
                           else d.name in names))
        covered, reach = 0, s.t0
        for t0, t1 in inner:
            if t1 > reach:
                covered += t1 - max(t0, reach)
                reach = t1
        return s.t1 - s.t0 - covered

    def write(self, path) -> None:
        """The spans as JSON lines: sid, name, parent, root, attrs, and
        start and end in ns on the wall clock."""
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(
                    {"sid": s.sid, "name": s.name, "parent": s.parent,
                     "root": s.root, "start_ns": self.wall(s.t0),
                     "end_ns": self.wall(s.t1), "attrs": s.attrs},
                    default=str) + "\n")

    def close(self) -> None:
        global _collector
        if _collector is self:
            _collector = None

    def __enter__(self) -> Collector:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def collect() -> Collector:
    """Open a collector (close it with ``close()`` or a ``with`` block)."""
    global _collector
    if _collector is not None:
        raise RuntimeError("a span collector is already open")
    _collector = Collector()
    return _collector


class Span:
    """A span that is on, and once closed in a collector its record:
    ``sid`` is its index in the collector's list, ``parent`` the sid of
    the span it was opened in, ``root`` the sid of its outermost span
    (its own for an outermost one); ``t0``, ``t1`` in ns on
    ``time.perf_counter_ns()``."""

    __slots__ = ("name", "attrs", "sid", "parent", "root", "t0", "t1",
                 "_col", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.sid = self.parent = self.root = self._col = self._fn = None
        self.t0 = self.t1 = 0

    def __repr__(self) -> str:
        return (f"Span({self.sid}, {self.name!r}, parent={self.parent}, "
                f"root={self.root}, ns={self.t1 - self.t0}, {self.attrs})")

    def set(self, **attrs) -> None:
        """Add attrs (a result known only at the end, such as a tier)."""
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        if _profiling():
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        col = self._col = _collector
        if col is not None:
            stack = col._stack
            self.sid = sid = len(col.spans)
            if stack:
                self.parent, self.root = stack[-1], stack[0]
            else:
                self.root = sid
            col.spans.append(self)
            stack.append(sid)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._col is not None:
            self.t1 = time.perf_counter_ns()
            self._col._stack.pop()
            self._col = None
        if self._fn is not None:
            self._fn.__exit__(*exc)
            self._fn = None


class _Off:
    """The span of the off path.  Its ``with`` protocol is two C calls
    (``__enter__`` gives the shared instance back, ``__exit__`` returns ''
    and so lets an exception through): a pair of Python methods costs
    twice as much, on each span of each call."""

    __slots__ = ()
    __exit__ = "".format

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()
_Off.__enter__ = itertools.repeat(_OFF).__next__


def span(name: str, **attrs):
    """A context manager over a region of the host's work (the module
    docstring); the shared no-op unless a collector is open or the
    profiler records."""
    if _collector is None and not _profiling():
        return _OFF
    return Span(name, attrs)


def sync(site: str):
    """The ``sync`` span of a host read of a device value, counted in
    ``sync.<site>``."""
    name = "sync." + site
    _counts[name] = _counts.get(name, 0) + 1
    return span("sync", site=site)


def count(name: str, k: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + k


def counts(prefix: str = "") -> collections.Counter:
    """The counters whose names start with ``prefix``, keyed without it;
    a counter never counted reads 0."""
    return collections.Counter({name[len(prefix):]: v
                                for name, v in _counts.items()
                                if name.startswith(prefix)})
