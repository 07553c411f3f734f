"""One run of one cell: the checks around the driver and the result line.

`main` resolves the cell's files (`registry`), refuses to run without
the cards the cell asks for, hands a `Context` to the cell's driver
(``drivers/<driver>.py``: set-up, warm-up, the window, the comparison),
and prints the result: the compared numbers on standard error as its last
lines, and as the last line of standard output one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and, for
a traced run, ``breakdown``), the compared numbers last under ``checks``.

A run exits with another code than 0, and prints no result, when the
cell or a file of it is unknown (2), when the cards are missing (3),
when the process has loaded JAX or the JAX package (4), or when the
checkout holds no program to measure (5).
"""
from __future__ import annotations

import contextlib
import gc
import json
import random
import sys
import time
from pathlib import Path
from typing import Optional

from harness import peaks as peaks_mod
from harness import registry
from harness import spans as spans_mod
from harness import trace as trace_mod

# top-level module names that may not be loaded in the process that
# prints a result: JAX and the JAX package of this repository
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of `FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a driver gets: the run's arguments, the cell's configuration
    and traffic, the device, and the calls that time the window, trace
    it and judge its outputs."""

    def __init__(self, args, cell: registry.Cell, t_start: float, device):
        self.args = args
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.device = device
        self.t_start = t_start
        self.rand = random.Random(args.seed)
        self.spans = spans_mod.Spans() if args.trace else None
        self.window_t0: Optional[float] = None
        self.window_t1: Optional[float] = None
        self.setup_s: Optional[float] = None
        self.profiler = None
        self.memory_peak_bytes = 0
        self.plans: list = []
        self.launches: list = []
        self.verdict: Optional[dict] = None
        self.reference_s: Optional[float] = None
        self.attempted = 0
        self.failed = 0
        self.route: dict = {}
        # set-up's phases: perf_counter when each ended
        self.marks: dict = {"start": t_start}

    # ---- window ------------------------------------------------------
    @contextlib.contextmanager
    def window(self, wraps=()):
        """The window: set-up ends and ``window_t0`` is taken on entry.  In
        a traced run the window lies inside one profiler session, started
        first, with a span around each call of every (module, attribute,
        name) of ``wraps``."""
        undo = []
        if self.args.trace:
            undo = [spans_mod.wrap(self.spans, m, a, n) for m, a, n in wraps]
            self.profiler = trace_mod.Profiler(self.device)
            self.profiler.start()
        self.window_t0 = time.perf_counter()
        self.setup_s = self.window_t0 - self.t_start
        try:
            yield
        finally:
            if self.profiler is not None:
                self.profiler.stop()
            for u in reversed(undo):
                u()

    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card():
            import torch

            torch.cuda.synchronize(self.device)

    def end_window(self, t_end: float) -> None:
        self.window_t1 = t_end
        if self.on_card():
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
                self.device))

    def free_program(self) -> None:
        """Release the program's card memory before the reference runs."""
        gc.collect()
        if self.on_card():
            import torch

            torch.cuda.empty_cache()

    # ---- result ------------------------------------------------------
    def e2e_metrics(self) -> dict:
        ticks = sum(p.point_ticks for p in self.plans)
        secs = self.window_t1 - self.window_t0
        values = {"point_ticks_per_s": ticks / secs / 1e6,
                  "setup_s": self.setup_s}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in self.cell.end_to_end}

    def view(self) -> trace_mod.View:
        import torch

        p = self.profiler
        window = (p.t0_ns, p.t1_ns)
        return trace_mod.View(
            plans=self.plans, spans=self.spans,
            events=trace_mod.clip(p.device_events(), window),
            window=window, launches=self.launches,
            peaks=peaks_mod.peaks_for(torch.cuda.get_device_name(
                self.device)))

    def layer_metrics(self, view: trace_mod.View) -> dict:
        out = {}
        for m in self.cell.per_layer:
            reader = registry.load_module(self.cell.reader_paths[m["name"]],
                                          "layer_metric_" + m["name"])
            value = reader.read(view)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def _device_info(ctx: Context) -> dict:
    import torch

    kind = (torch.cuda.get_device_name(ctx.device) if ctx.on_card()
            else "cpu")
    return {"platform": "gpu" if ctx.on_card() else "cpu", "kind": kind,
            "count": ctx.cell.chips,
            "memory_peak_bytes": ctx.memory_peak_bytes}


def power_limit() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(ctx: Context) -> dict:
    """The cell's driver on ``ctx``, then the result line's object."""
    driver = registry.load_module(ctx.cell.driver_path,
                                  "driver_" + ctx.config["driver"])
    driver.run(ctx)
    result = {"correct": bool(ctx.verdict["correct"]),
              "attempted": ctx.attempted, "failed": ctx.failed}
    if ctx.args.trace:
        view = ctx.view()
        result["metrics"] = ctx.layer_metrics(view)
        result["device"] = dict(_device_info(ctx), busy_s=view.busy_s(),
                                window_s=view.window_s)
        result["breakdown"] = trace_mod.breakdown(view)
    else:
        result["metrics"] = ctx.e2e_metrics()
        result["device"] = _device_info(ctx)
    result["route"] = ctx.route
    names = list(ctx.marks)
    result["setup_parts_s"] = {b: ctx.marks[b] - ctx.marks[a]
                               for a, b in zip(names, names[1:])}
    result["plan_s"] = [p.t1 - p.t0 for p in ctx.plans]
    result["reference_s"] = ctx.reference_s
    result["judged"] = ctx.verdict["info"]
    result["checks"] = ctx.verdict["numbers"]
    return result


def main(args, t_start: float, root: Path) -> int:
    try:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cell = registry.load_cell(bench, args.workload)
    except (OSError, registry.UnknownName) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    if not (root / "src" / "repro_torch").is_dir():
        print("perfbench: no program (src/repro_torch) in this checkout",
              file=sys.stderr)
        return 5
    marks = {"start": t_start, "args": time.perf_counter()}
    import torch

    marks["torch"] = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    marks["cuda"] = time.perf_counter()
    ctx = Context(args, cell, t_start, device)
    ctx.marks = marks
    result = run_cell(ctx)
    checks = result.pop("checks")
    result["card"] = power_limit()
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(f"judged: {json.dumps(result['judged'])}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
