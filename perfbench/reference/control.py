"""The comparison's control: the reference in bfloat16 in the program's
place.

    python3 perfbench/reference/control.py --workload <cell> --seed <n>

For the plan a run with ``--seed n`` starts its window with (the stream's
plan after the warm-up), the points a run would judge of it are drawn as
a run draws them, simulated by the reference with its state held in
bfloat16 between ticks (`fluid.bf16`, the nearest precision below the
configuration's float32), and judged against the float32 reference as
the program's answers are (`judge`).  Prints one JSON line: the cell,
the seed and the comparison's numbers.  Needs no card; `correct` has to
come out false.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from harness import registry  # noqa: E402
from reference import fluid, judge  # noqa: E402


def judged_points(cell: registry.Cell, seed: int) -> list[dict]:
    """The points a run with ``seed`` would judge of its window's first
    plan."""
    drv = registry.load_module(cell.driver_path,
                               "driver_" + cell.config["driver"])
    per_plan = int(cell.traffic["seeds_per_plan"])
    first = drv.seed_stream(seed) + per_plan * int(
        cell.traffic.get("warmup_plans", 1))
    points = drv.plan_points(cell.config,
                             list(range(first, first + per_plan)))
    rand = random.Random(seed)
    idx = sorted(rand.sample(range(len(points)), min(
        int(cell.traffic["judged_points"]), len(points))))
    return [points[i] for i in idx]


def control(cell: registry.Cell, seed: int, worker: bool = True) -> dict:
    """The control's numbers for one seed."""
    points = judged_points(cell, seed)
    ref = fluid.simulate(cell.config, points, worker=worker)
    low = fluid.simulate(cell.config, points, quantize=fluid.bf16,
                         worker=worker)
    per_point = []
    for i, p in enumerate(points):
        n = int(p["n_jobs"])
        prog = fluid.postprocess(low, i, n)
        prog["result_traces"] = {k: prog[k] for k in judge.RESULT_TRACES}
        per_point.append(judge.compare_point(prog, fluid.postprocess(
            ref, i, n)))
    return judge.judge(per_point, cell.config["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = registry.load_cell(bench, args.workload)
    out = control(cell, args.seed)
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          correct=out["correct"], numbers=out["numbers"],
                          judged=out["info"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
