"""Shared set-up of the benchmark's CPU tests: the benchmark's folder and
the port's sources on the import path, and a cell cut to a few hundred
ticks that runs on the CPU (the kernels' plain versions)."""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(ROOT / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(name: str, sim_time: float = 0.01, n_chunks: int = 5):
    """The cell ``name`` with its simulated time cut (the shapes kept)."""
    from harness import registry

    cell = registry.load_cell(bench_json(), name)
    cell.config = dict(copy.deepcopy(cell.config), sim_time=sim_time,
                       n_chunks=n_chunks)
    return cell


def cpu_run(cell, seed: int = 3_000_000_123, seconds: float = 0.5):
    """One run of ``cell`` on the CPU, past the harness's look for a card:
    the result line's object."""
    import torch

    from harness import context

    args = argparse.Namespace(workload=cell.name, seed=seed,
                              seconds=seconds, trace=0)
    ctx = context.Context(args, cell, time.perf_counter(),
                          torch.device("cpu"))
    return context.run_cell(ctx)


@pytest.fixture
def cells():
    return [w["name"] for w in bench_json()["workloads"]]
