"""Figure 11 / Table 2 — model and parallelization diversity
(``benchmarks/diversity.py``).

The Table-2 snapshots (models, batch sizes, parallelism, placement on the
two-tier fabric) run with DCQCN against MLQCN; "ideal" is each job alone.
The paper: MLQCN lands within ~5% of ideal on average.

One plan over all snapshots: snap x scheme x solo x seed.  Snapshots of one
phase structure merge into one group per scheme.  A job alone is the
padded-jobs mask (`job_active` one-hot), so it keeps the full fabric and
JobSpec and rides the baseline's group.  Every number is seed-averaged.
"""
from __future__ import annotations

import numpy as np

from repro_torch import netsim, workload
from repro_torch.figures import common

N_JOBS = 2                      # every Table-2 snapshot pairs two jobs


def _solo_mask(v):
    if v == "all":
        return np.ones((N_JOBS,), bool)
    mask = np.zeros((N_JOBS,), bool)
    mask[v] = True
    return mask


def _isolation_only_base(pt) -> bool:
    # isolation points only need the baseline protocol
    return pt["solo"] == "all" or pt["scheme"] == "base"


def make_plan() -> netsim.Plan:
    """The Table 2 grid as a plan, buildable without running."""
    by_name = {s.name: s for s in workload.table2_snapshots(sockets_per_job=2)}

    def build(pt):
        snap = by_name[pt["snap"]]
        variant = "WI" if pt["scheme"] == "mlqcn" else "OFF"
        return common.build_cfg(snap.topo, list(snap.profiles),
                                common.protocol("dcqcn", variant))

    return common.plan(
        build, name="table2", where=_isolation_only_base,
        snap=tuple(by_name),
        scheme=("base", "mlqcn"),
        solo=netsim.Axis("solo", ("all",) + tuple(range(N_JOBS)),
                         field="job_active", resolve=_solo_mask),
        seed=common.seed_axis())


def run(device=None) -> tuple[dict, int]:
    snaps = workload.table2_snapshots(sockets_per_job=2)
    pr = common.run_plan(make_plan(), device=device)
    # one group per (scheme, phase structure): single-phase snapshots merge
    if not pr.n_compile_groups <= 4:
        raise AssertionError(pr.n_compile_groups)
    if pr.n_kernel_fallbacks != 0:
        raise AssertionError()

    out = {}
    for snap in snaps:
        profs = list(snap.profiles)
        base = pr.select(snap=snap.name, scheme="base", solo="all")
        ml = pr.select(snap=snap.name, scheme="mlqcn", solo="all")
        sp = netsim.sweep_speedup_stats(base, ml)
        # per job: MLQCN's seed-mean avg iteration over the job's run alone
        # (warmup=2: short smoke windows record few iterations per job)
        vs_ideal = []
        for j in range(len(profs)):
            iso = np.mean([r.avg_iter(j, warmup=2)
                           for r in pr.select(snap=snap.name, scheme="base",
                                              solo=j)])
            mlj = np.mean([r.avg_iter(j, warmup=2) for r in ml])
            vs_ideal.append(mlj / iso)
        out[snap.name] = {
            "compat_measured": round(workload.compatibility_score(
                profs[0].scaled(common.WORK_SCALE),
                profs[1].scaled(common.WORK_SCALE)), 3),
            "compat_paper": snap.compat_paper,
            "avg_speedup": round(sp["avg_speedup"], 3),
            "p99_speedup": round(sp["p99_speedup"], 3),
            "vs_ideal": round(float(np.mean(vs_ideal)), 3),
        }
    return out, pr.n_ticks


if __name__ == "__main__":
    import json
    print(json.dumps(run()[0], indent=1))
