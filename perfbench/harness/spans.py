"""Host spans the benchmark records around the calls into each layer.

A span is (name, start ns, end ns) on the host's ``time.time_ns`` clock,
the clock the profiler's device records are stamped in.  A recorder of
None records nothing, so the untimed paths pay one check.
"""
from __future__ import annotations

import contextlib
import time


class Spans:
    """Spans kept in memory for the traced run."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    def total_s(self, name: str) -> float:
        return sum(b - a for n, a, b in self.items if n == name) * 1e-9

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.items if n == name)


@contextlib.contextmanager
def span(rec, name: str):
    if rec is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        rec.items.append((name, t0, time.time_ns()))


def wrap(rec, module, attr: str, name: str):
    """Record a span around every call of ``module.attr``; returns the
    function that puts the original back."""
    original = getattr(module, attr)

    def wrapped(*args, **kw):
        t0 = time.time_ns()
        try:
            return original(*args, **kw)
        finally:
            rec.items.append((name, t0, time.time_ns()))

    setattr(module, attr, wrapped)
    return lambda: setattr(module, attr, original)
