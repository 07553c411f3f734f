"""The traced run's device records and what is reduced from them.

`Profiler` holds one `torch.profiler` session (device activity only)
over the window.  The run sets ``TEARDOWN_CUPTI=1`` before torch loads,
so that the session starts from a fresh CUPTI state and keeps every
device record; with it, a process whose last CUDA work is a traced
session does not exit, so `Profiler.stop` makes one more CUDA call.

`View` is what a per-layer metric's reader (``layer_metrics/<name>.py``)
reads: the window's plans, the host spans, the device records clipped to
the window, and the chunk kernel's launches with their shapes.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional


class Profiler:
    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        self.prof.__enter__()
        self.torch.cuda.synchronize(self.device)
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)
        # the CUPTI teardown completes in a later CUDA call
        self.torch.zeros(1, device=self.device).add_(1.0)
        self.torch.cuda.synchronize(self.device)

    def device_events(self) -> list[tuple[str, int, int]]:
        """(name, start ns, end ns) of every device record."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                out.append((e.name(), e.start_ns(),
                            e.start_ns() + e.duration_ns()))
        return out


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class View:
    plans: list                      # the window's PlanRecords
    spans: object                    # harness.spans.Spans
    events: list                     # (name, start ns, end ns), clipped
    window: tuple                    # (start ns, end ns)
    launches: list                   # dicts: algo, K, N, M, J, T, D, P, count
    peaks: dict                      # harness.peaks row of the card

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        return sum(b - a for a, b in merge(
            [(a, b) for _, a, b in self.events])) * 1e-9

    def kernel_s(self, name: str) -> Optional[float]:
        """Device seconds of the records whose name holds ``name``."""
        times = [b - a for n, a, b in self.events if name in n]
        return sum(times) * 1e-9 if times else None

    def group_ticks(self) -> int:
        return sum(p.group_ticks for p in self.plans)


def clip(events, window) -> list[tuple[str, int, int]]:
    w0, w1 = window
    return [(n, max(a, w0), min(b, w1)) for n, a, b in events
            if b > w0 and a < w1]


# span names from the innermost out: a gap takes the first that is open
NESTING = ("chunk_inputs", "postprocess", "run_group", "run_plan",
           "build_plan")
NAME_CHARS = 160


def open_span(spans_by_name: dict, t: int) -> str:
    """The innermost span open at ``t`` (``between_plans``: none)."""
    for name in NESTING:
        starts, ends = spans_by_name.get(name, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ends[i] >= t:
            return name
    return "between_plans"


def breakdown(view: View, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by the host span open at each gap's midpoint."""
    by_op: dict[str, int] = {}
    for n, a, b in view.events:
        by_op[n[:NAME_CHARS]] = by_op.get(n[:NAME_CHARS], 0) + (b - a)
    busy = merge([(a, b) for _, a, b in view.events])
    gaps, cur = [], view.window[0]
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if view.window[1] > cur:
        gaps.append((cur, view.window[1]))
    spans_by_name: dict = {}
    for name in NESTING:
        items = sorted((a, b) for n, a, b in view.spans.items if n == name)
        spans_by_name[name] = ([a for a, _ in items], [b for _, b in items])
    by_span: dict[str, int] = {}
    for a, b in gaps:
        name = open_span(spans_by_name, (a + b) // 2)
        by_span[name] = by_span.get(name, 0) + (b - a)

    def rows(d):
        return [[k, v * 1e-9] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": rows(by_op), "idle_gaps": rows(by_span)}
