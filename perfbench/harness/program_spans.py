"""The program's own spans in a traced run, beside the device records.

The port records host spans along a plan's path while a profiler session
is open (`repro_torch.netsim.counters.spans`: plan, params, group, load,
setup, loop, chunk_inputs, draws, run_chunk, drain, fetch, postprocess),
on ``time.time_ns``, the clock the device records are stamped in.
`spans` takes those that overlap the traced window, clipped to it;
`idle_gaps` puts each gap between the device records down to the program
spans open at the gap's midpoint, innermost last.  Both return None where
the program keeps no span log (an older checkout of the port); neither
raises there.
"""
from __future__ import annotations

import bisect
import sys
from typing import NamedTuple, Optional

from harness import trace as trace_mod

# the name of a gap's midpoint that lies in no program span
OUTSIDE = "outside"


class ProgramSpan(NamedTuple):
    name: str
    start: int             # ns, clipped to the window
    end: int
    parent: int            # index of the enclosing span; -1
    count: int


def spans(view) -> Optional[dict[int, ProgramSpan]]:
    """The program's spans that overlap ``view.window``, clipped to it, by
    their index in the program's log; None without a span log."""
    counters = sys.modules.get("repro_torch.netsim.counters")
    read = getattr(counters, "spans", None)
    if read is None:
        return None
    w0, w1 = view.window
    out = {}
    for i, s in enumerate(read()):
        if s.end_ns > w0 and s.start_ns < w1:
            out[i] = ProgramSpan(s.name, max(s.start_ns, w0),
                                 min(s.end_ns, w1), s.parent, s.count)
    return out


def device_gaps(view) -> list[tuple[int, int]]:
    """The window's intervals (ns) in which no device record runs."""
    busy = trace_mod.merge([(a, b) for _, a, b in view.events])
    out, cur = [], view.window[0]
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if view.window[1] > cur:
        out.append((cur, view.window[1]))
    return out


def idle_gaps(view) -> Optional[list[tuple[int, tuple[str, ...]]]]:
    """Each device gap as (ns, the names of the program spans open at its
    midpoint, outermost first; empty where none is); None without a span
    log."""
    by_index = spans(view)
    if by_index is None:
        return None
    order = sorted(by_index, key=lambda i: (by_index[i].start,
                                             -by_index[i].end, i))
    starts = [by_index[i].start for i in order]
    out = []
    for a, b in device_gaps(view):
        t = (a + b) // 2
        # the last span to start by t, or the first of its ancestors still
        # open at t, is the innermost open at t (spans nest)
        k = bisect.bisect_right(starts, t) - 1
        i = order[k] if k >= 0 else -1
        while i in by_index and by_index[i].end < t:
            i = by_index[i].parent
        path = []
        while i in by_index:
            path.append(by_index[i].name)
            i = by_index[i].parent
        out.append((b - a, tuple(reversed(path))))
    return out


def idle_by_span(view) -> Optional[dict[str, float]]:
    """Device idle seconds by the innermost program span open at each gap's
    midpoint (`OUTSIDE` for none), largest first; None without a span
    log."""
    gaps = idle_gaps(view)
    if gaps is None:
        return None
    out: dict[str, int] = {}
    for ns, path in gaps:
        name = path[-1] if path else OUTSIDE
        out[name] = out.get(name, 0) + ns
    return {k: v * 1e-9 for k, v in sorted(out.items(),
                                           key=lambda kv: -kv[1])}
