"""Finds a cell's files by the names `BENCHMARK.json` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness reads ``configs/<config>.json`` and
``traffic/<traffic>.json``, runs the driver ``drivers/<driver>.py`` that
the configuration names, and reads each per-layer metric of the cell with
``layer_metrics/<metric>.py``.  Adding a cell adds files and an entry;
no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


class UnknownName(LookupError):
    pass


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver_path: Path
    end_to_end: list[dict]
    per_layer: list[dict]
    reader_paths: dict[str, Path]


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _file(base: Path, kind: str, name: str, suffix: str) -> Path:
    path = base / kind / f"{name}{suffix}"
    if not path.is_file():
        raise UnknownName(f"no {kind} file {path.name} for {name!r}")
    return path


def load_cell(bench: dict, name: str, base: Path = HERE) -> Cell:
    """The cell ``name`` of the benchmark ``bench`` (BENCHMARK.json's
    contents) with every file it names resolved under ``base`` (the
    benchmark's folder); `UnknownName` if the cell or one of its files
    does not exist."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise UnknownName(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    config = json.loads(
        _file(base, "configs", w["config"], ".json").read_text())
    traffic = json.loads(
        _file(base, "traffic", w["traffic"], ".json").read_text())
    per_layer = [m for m in bench["per_layer"] if _for_cell(m, name)]
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        driver_path=_file(base, "drivers", config["driver"], ".py"),
        end_to_end=[m for m in bench["end_to_end"] if _for_cell(m, name)],
        per_layer=per_layer,
        reader_paths={m["name"]: _file(base, "layer_metrics", m["name"],
                                       ".py")
                      for m in per_layer})


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (file names may hold
    dots, so not through the import path)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
