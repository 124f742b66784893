"""Spans around the program's functions, recorded from the benchmark's own
files.

A span target is ``"<module>:<attribute>"``, a module-level function of
the program.  :class:`Recorder` replaces each target by a wrapper for
the length of a ``with`` block (the traced run only) and puts the
original back after it.  The program calls these functions through
their modules (``gram_stream.stream(...)``, ``tsqr_mod.tsqr(...)``), so
the wrapper sees every call; a caller that bound the function by name
before the block would not be seen.  Each call becomes a :class:`Span`
with its host-clock interval, a summary of its arguments (shapes and
dtypes of tensors, plain values as they are) and the targets it was
called inside, and a ``torch.profiler`` annotation of the same interval,
named :func:`label`, through which the trace reader assigns device
operations to the span whose host interval launched them.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import itertools
import time

import torch

PREFIX = "qrbench.span"


def label(key: str, sid: int) -> str:
    return f"{PREFIX}|{key}|{sid}"


def parse_label(name: str) -> tuple[str, int] | None:
    """(key, sid) of a span's annotation name, None for another name."""
    parts = name.split("|")
    if len(parts) != 3 or parts[0] != PREFIX:
        return None
    return parts[1], int(parts[2])


@dataclasses.dataclass
class Span:
    key: str
    sid: int
    t0: float
    t1: float
    args: dict
    outer: tuple[str, ...]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def summarize(value, depth: int = 0):
    """A small, JSON-able account of an argument."""
    if isinstance(value, torch.Tensor):
        return {"shape": list(value.shape),
                "dtype": str(value.dtype).removeprefix("torch."),
                "device": value.device.type}
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, str):
        return str(value)   # a str enum gives its value
    if value is None or isinstance(value, (bool, int, float)):
        return value
    if isinstance(value, (list, tuple)) and depth < 2:
        return [summarize(v, depth + 1) for v in value[:16]]
    name = getattr(value, "name", None)   # a mode policy gives its mode
    return name if isinstance(name, str) else type(value).__name__


class Recorder:
    """``with Recorder(targets) as rec: ...`` records ``rec.spans``."""

    def __init__(self, targets):
        self.targets = sorted(set(targets))
        self.spans: list[Span] = []
        self._ids = itertools.count()
        self._stack: list[str] = []
        self._saved: list[tuple[object, str, object]] = []

    def __enter__(self) -> "Recorder":
        for target in self.targets:
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(f"{mod_name}.{attr}", fn))
        return self

    def __exit__(self, *exc) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def _wrap(self, key: str, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            sid = next(self._ids)
            outer = tuple(self._stack)
            self._stack.append(key)
            try:
                with torch.profiler.record_function(label(key, sid)):
                    t0 = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        t1 = time.perf_counter()
            finally:
                self._stack.pop()
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                self.spans.append(Span(
                    key, sid, t0, t1,
                    {k: summarize(v) for k, v in bound.arguments.items()},
                    outer))
        return wrapper

    def outermost(self, key: str) -> list[Span]:
        """The spans of ``key`` not called inside another span of it."""
        return [s for s in self.spans if s.key == key and key not in s.outer]
