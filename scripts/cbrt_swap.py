#!/usr/bin/env python3
"""How far the cube root alone moves the reference's fig 7-9 CUBIC cell.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/cbrt_swap.py \
        [--seeds 32] [--out cbrt_swap.json]

The port computes CUBIC's K = cbrt(w_max (1 - beta) / C) with its own cube
root (`repro_torch.core.cc.cubic.cbrt`: a bit-pattern guess and four
Newton steps, within 1 ulp), the reference with XLA's ``jnp.cbrt`` (up to
15 ulp away on the CPU).  This script runs the reference's own fig 7-9
plan (captured from ``benchmarks/convergence.py`` as
`reference_plans.captured_plan` does, cut to CUBIC) at seeds 1..N on the
CPU twice, each in a process of its own: as it is, and with ``jnp.cbrt``
replaced, for that process only, by the port's cube root written in jnp
ops (nothing under ``src/repro/`` changes).  It prints each seed's
``converged_at_iter`` and ``mltcp_interleave`` under both roots (the
values `reference_plans.figure_cells` reads) and a two-sided
Mann-Whitney U between the two samples.  A swap of one rounding that
moves single seeds as far as the port's gap from the reference, while the
two distributions agree, shows that the per-seed gaps are chaos: the runs
amplify an ulp into a different trajectory.  ~1 min at 32 seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("converged_at_iter", "mltcp_interleave")
# repro_torch/core/cc/cubic.py's constants
CBRT_MAGIC = 0x2A51067F
CBRT_NEWTON_STEPS = 4
FLT_MIN = 1.1754943508222875e-38


def newton_cbrt(x):
    """`repro_torch.core.cc.cubic.cbrt` in jnp ops."""
    import jax.numpy as jnp
    from jax import lax

    a = jnp.abs(x)
    small = a < FLT_MIN
    a = jnp.where(small, a * 16777216.0, a)
    y = lax.bitcast_convert_type(
        lax.bitcast_convert_type(a, jnp.int32) // 3 + CBRT_MAGIC,
        jnp.float32)
    for _ in range(CBRT_NEWTON_STEPS):
        y = y + (a / (y * y) - y) * (1.0 / 3.0)
    y = jnp.where(small, y * 0.00390625, y)
    y = jnp.where((a == 0.0) | jnp.isinf(a), a, y)
    return jnp.copysign(y, x)


def run(root: str, seeds: tuple) -> dict:
    """The reference's fig 7-9 CUBIC cell at ``seeds``, with ``root``
    ("jnp" or "newton") as its cube root."""
    import dataclasses

    os.environ["REPRO_SMOKE"] = "1"
    os.environ["REPRO_FULL"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tests"),
                    os.path.join(ROOT, "scripts")]
    import jax.numpy as jnp
    import reference_plans as rp
    from _torch_reference import reference_modules

    if root == "newton":
        jnp.cbrt = newton_cbrt
    with reference_modules():
        from benchmarks import common
        from repro import netsim, workload

        common.SEEDS = seeds
        plan, kw = rp.captured_plan("fig7-9")
        plan = dataclasses.replace(plan, axes=tuple(
            dataclasses.replace(ax, values=("cubic",))
            if ax.name == "algo" else ax for ax in plan.axes))
        pr = netsim.run_plan(plan, **kw)
        cell = rp.figure_cells("fig7-9", netsim, workload, pr)["cubic"]
    return {m: cell[m] for m in METRICS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=32, metavar="N")
    ap.add_argument("--out", help="also write the result here as JSON")
    ap.add_argument("--root", choices=("jnp", "newton"),
                    help="run one root in this process and print its cell")
    args = ap.parse_args(argv)
    seeds = tuple(range(1, args.seeds + 1))
    if args.root:
        print(json.dumps(run(args.root, seeds)), flush=True)
        return 0
    from scipy import stats

    cells = {}
    for root in ("jnp", "newton"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--seeds", str(args.seeds)], check=True, capture_output=True,
            text=True)
        cells[root] = json.loads(out.stdout.strip().splitlines()[-1])
    result = dict(seeds=list(seeds), cells=cells, mann_whitney={})
    for m in METRICS:
        x, y = ([v for v in cells[r][m] if v is not None]
                for r in ("jnp", "newton"))
        p = float(stats.mannwhitneyu(x, y, alternative="two-sided").pvalue)
        result["mann_whitney"][m] = dict(
            p=p, jnp_mean=sum(x) / len(x), newton_mean=sum(y) / len(y))
        print(f"{m}: jnp.cbrt mean {sum(x) / len(x):.6g}, Newton cbrt mean "
              f"{sum(y) / len(y):.6g}, Mann-Whitney p {p:.4g}")
        print("  seeds 1-3:", cells["jnp"][m][:3], "->",
              cells["newton"][m][:3])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
