"""The result line: its keys and their order, the metrics of each kind
of run, and the exits that print no result."""
import json
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT, cpu_run, tiny_cell

from harness import trace


def test_result_keys_and_metrics():
    r = cpu_run(tiny_cell("fig10-dcqcn.seeds3"))
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(r["metrics"]) == {"point_ticks_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert r["attempted"] == 30 * r["route"]["plans"] and r["failed"] == 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["checks"]["diverged_pct"] == {"value": 0.0, "limit": 0.0}
    json.dumps(r)


def _run(*args, cwd=ROOT):
    return subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    out = _run("--workload", "fig10-reno.seeds3", "--seed", "7",
               "--seconds", "1", "--trace", "0")
    assert out.returncode == 3 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's folder
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "fig10-reno.seeds3", "--seed", "7", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_workload_no_result():
    out = _run("--workload", "no-such-cell", "--seed", "7", "--seconds",
               "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""


def _view(events, spans, window=(0, 1000)):
    from harness.spans import Spans

    rec = Spans()
    rec.items = spans
    plan = type("P", (), dict(t0=0.0, t1=1.0, execute_s=0.75,
                              group_ticks=100))()
    return trace.View(plans=[plan], spans=rec, events=events, window=window,
                      launches=[dict(algo="reno", K=15, N=12, M=1, J=6,
                                     T=187, D=5, P=1, count=2)],
                      peaks={"f32_flops": 67e12, "hbm_bytes": 3.35e12})


def test_readers_and_breakdown():
    from harness import registry

    events = [("void netsim_chunk::netsim_chunk_kernel<0>", 100, 400),
              ("Memcpy HtoD", 350, 450), ("netsim_chunk_kernel<0>", 600,
                                          900)]
    spans = [("run_plan", 0, 1000), ("run_group", 50, 950),
             ("chunk_inputs", 450, 600), ("postprocess", 950, 1000)]
    view = _view(events, spans)
    assert view.busy_s() == pytest.approx(650e-9)
    read = {p.stem: registry.load_module(p, "t_" + p.stem).read
            for p in (BENCH / "layer_metrics").glob("*.py")}
    assert read["device.idle_pct"](view) == pytest.approx(35.0)
    assert read["plan.host_pct"](view) == pytest.approx(25.0)
    assert read["chunk_kernel.us_per_tick"](view) == pytest.approx(6e-3)
    assert read["chunk_inputs.us_per_tick"](view) == pytest.approx(1.5e-3)
    assert read["chunk_kernel_roofline"](view) > 0
    b = trace.breakdown(view)
    assert b["device_ops"][0][0].startswith("void netsim_chunk")
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"run_group": 100e-9, "chunk_inputs": 150e-9,
         "postprocess": 100e-9})
    # a reader that finds nothing to read returns nothing
    empty = _view([], [])
    assert read["chunk_kernel.us_per_tick"](empty) is None
    assert read["chunk_kernel_roofline"](empty) is None
    assert read["device.idle_pct"](empty) is None
    assert read["chunk_inputs.us_per_tick"](empty) is None
