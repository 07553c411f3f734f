"""What the benchmark loads: neither JAX nor the JAX package (`repro`,
whose name begins the port's, compared as whole top-level names) in the
import closure of ``perfbench/run.py`` or in a whole run; and the traced
run sets TEARDOWN_CUPTI before torch loads."""
import json
import subprocess
import sys

from conftest import BENCH, ROOT

from harness import context

SCAN = r"""
import json, sys
sys.argv = ["run.py"]
sys.path.insert(0, {bench!r})
import run
run.prepare(run.parse(["--workload", "x", "--seed", "1", "--seconds", "1"]))
from harness import context, registry
from pathlib import Path
for kind in ("drivers", "layer_metrics"):
    for p in sorted(Path({bench!r}, kind).glob("*.py")):
        registry.load_module(p, kind + "_" + p.stem)
import reference.fluid, reference.judge, reference.control
import repro_torch.netsim, repro_torch.kernels.ops
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

RUN_CELL = r"""
sys.path.insert(0, {tests!r})
from conftest import cpu_run, tiny_cell
assert cpu_run(tiny_cell("fig10-reno.seeds3"))["correct"]
"""


def _modules(extra=""):
    code = SCAN.format(bench=str(BENCH), extra=extra.format(
        tests=str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_import_closure_holds_no_jax():
    names = _modules()
    assert "repro_torch" in names and "torch" in names
    assert not names & context.FORBIDDEN


def test_a_whole_run_loads_no_jax():
    assert not _modules(RUN_CELL) & context.FORBIDDEN


def test_forbidden_names_compare_whole_top_levels():
    assert context.forbidden_modules(["repro_torch", "repro_torch.netsim",
                                      "reproduce", "jaxtyping"]) == []
    assert context.forbidden_modules(["repro.netsim", "jax._src",
                                      "flax"]) == ["flax", "jax._src",
                                                   "repro.netsim"]


def test_trace_sets_teardown_before_torch_loads():
    code = r"""
import importlib.abc, os, sys
seen = []
class Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "torch":
            seen.append(os.environ.get("TEARDOWN_CUPTI"))
        return None
sys.meta_path.insert(0, Finder())
sys.path.insert(0, {bench!r})
import run
rc = run.main(["--workload", "fig10-reno.seeds3", "--seed", "1",
               "--seconds", "1", "--trace", "1"])
print(rc, seen)
""".format(bench=str(BENCH))
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "TEARDOWN_CUPTI"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split()[-2:] == ["3", "['1']"], out.stderr[-2000:]
