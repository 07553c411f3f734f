"""The harness finds every cell's files by the names in BENCHMARK.json,
refuses an unknown one, and BENCHMARK.json keeps its required shape."""
import json
import re
import shutil

import pytest
from conftest import BENCH, ROOT, bench_json

from harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_resolves(cells):
    bench = bench_json()
    for name in cells:
        cell = registry.load_cell(bench, name)
        assert cell.driver_path.is_file()
        assert set(cell.reader_paths) == {m["name"] for m in cell.per_layer}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.config["limits"] and cell.traffic["seeds_per_plan"] > 0


@pytest.mark.parametrize("change", ["workload", "config", "traffic",
                                    "driver", "metric"])
def test_unknown_names_are_refused(tmp_path, change):
    bench = bench_json()
    w = dict(bench["workloads"][0])
    if change == "workload":
        with pytest.raises(registry.UnknownName):
            registry.load_cell(bench, "no-such-cell")
        return
    if change in ("config", "traffic"):
        w[change] = "no-such-" + change
    elif change == "metric":
        bench["per_layer"] = bench["per_layer"] + [dict(
            bench["per_layer"][0], name="no.such_metric")]
    else:
        # a copy of the folder whose configuration names a driver that is
        # not there
        base = tmp_path / "perfbench"
        shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
            "__pycache__", "tests"))
        path = base / "configs" / f"{w['config']}.json"
        cfg = json.loads(path.read_text())
        path.write_text(json.dumps(dict(cfg, driver="no_such_driver")))
        with pytest.raises(registry.UnknownName):
            registry.load_cell(bench, w["name"], base=base)
        return
    with pytest.raises(registry.UnknownName):
        registry.load_cell(dict(bench, workloads=[w]), w["name"])


def test_benchmark_json_shape():
    bench = bench_json()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        names.add(c["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == names
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"point_ticks_per_s", "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", ())) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    everything = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
                  + bench["per_layer"])
    assert all(NAME.match(x["name"]) for x in everything)
    assert all(len(w["why"]) <= 200 for w in bench["workloads"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
