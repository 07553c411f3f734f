"""Named lintable plans: the figure suites' grids, resolvable without
running them.

Each plan is its suite's own builder in `repro_torch.figures` (as the
JAX package's registry imports its ``benchmarks/`` suites' plans), built at
a depth given here.  The five plans the ``--ci`` gate proves
(``CI_PLANS``):

* ``fig12``: `stragglers.make_plan`;
* ``fig13``: `partial_compat.make_plan`;
* ``fig5``: `timeline.make_plan`, armed with the suite's probes
  (`fig5_spec`); the registry lints it armed and unarmed;
* ``kernel_sweep``: `kernel_sweep.make_plan` (the port has no kernel
  switch: every run of it takes the chunk kernel on the card);
* ``churn``: `churn.make_plan`, telemetry and faults armed.

Beside them, ``FIGURES`` holds the other figure suites' plans as plain
builders (no registry entry, no CLI name), which ``chip_smoke.py``'s
``figures`` phase runs on the card: ``fig7-9`` (`convergence.make_plan`),
``table2`` (`diversity.make_plan`), ``fig13``, ``fig14``
(`circular.make_plan`), ``fig15``, ``fig16`` and ``fig17``
(`parameters.fig15_plan` ...) and ``kernel_sweep``; `fig10_plan` builds
`speedup_vs_jobs._plan`.

The depth follows `figures.common.depth`: ``REPRO_SMOKE=1`` 1.5 s and
seed 1, ``REPRO_FULL=1`` 20 s, seeds 1-3 and the unscaled workload, else
4 s and seeds 1-2 (the churn plan runs 18 s times the workload scale);
`depth` reads the environment when a plan is built, and every builder
also takes the simulated time and the seeds explicitly, as
``chip_smoke.py`` calls them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

from repro_torch.figures import (churn, circular, common, convergence,
                                 diversity, kernel_sweep, parameters,
                                 partial_compat, speedup_vs_jobs, stragglers,
                                 timeline)

__all__ = ["PlanEntry", "PLANS", "CI_PLANS", "FIGURES", "resolve_entry",
           "depth", "protocol", "build_cfg", "fig7_9_plan", "table2_plan",
           "fig10_plan", "fig12_plan", "fig13_plan", "fig14_plan",
           "fig14_schedule", "fig15_plan", "fig16_plan", "fig17_plan",
           "fig5_spec", "fig5_plan", "kernel_sweep_plan", "churn_plan"]

protocol = common.protocol


def depth() -> dict:
    """The suites' scale, read from the environment now: ``work_scale``,
    ``sim_time``, ``seeds`` and the churn plan's ``churn_sim_time``."""
    d = common.depth()
    return dict(work_scale=d["WORK_SCALE"], sim_time=d["SIM_TIME"],
                seeds=d["SEEDS"], churn_sim_time=18.0 * d["WORK_SCALE"])


def build_cfg(topo, profiles, proto, *, sim_time: float, **kw):
    """`common.build_cfg` at `depth`'s workload scale."""
    return common.build_cfg(topo, profiles, proto, sim_time=sim_time,
                            scale=depth()["work_scale"], **kw)


@contextlib.contextmanager
def _at(sim_time: float, seeds: tuple, work_scale: float,
        churn_sim_time: float):
    """The suites' depth constants for the block, the churn suite's own
    simulated time among them."""
    saved = churn.SIM_TIME
    churn.SIM_TIME = churn_sim_time
    try:
        with common.at_depth(WORK_SCALE=work_scale, SIM_TIME=sim_time,
                             SEEDS=tuple(seeds)):
            yield
    finally:
        churn.SIM_TIME = saved


def _pin(sim_time: Optional[float], seeds, churn_plan: bool) -> tuple:
    """`_at`'s arguments: `depth` now, with ``sim_time`` (the churn
    suite's, for the churn plan) and ``seeds`` where given."""
    d = depth()
    churn_time = d["churn_sim_time"]
    if sim_time is not None and churn_plan:
        churn_time = sim_time
    elif sim_time is None:
        sim_time = d["sim_time"]
    return (sim_time, tuple(d["seeds"] if seeds is None else seeds),
            d["work_scale"], churn_time)


def _pinned(make: Callable, sim_time: Optional[float], seeds,
            churn_plan: bool = False):
    """``make()``'s plan, built, and each of its points built, at `depth`'s
    workload scale, ``sim_time`` (the suites' or, for the churn plan, the
    churn suite's simulated time; `depth`'s when None) and ``seeds``
    (`depth`'s when None)."""
    pin = _pin(sim_time, seeds, churn_plan)
    with _at(*pin):
        plan = make()

    def build(pt):
        with _at(*pin):
            return plan.build(pt)
    return dataclasses.replace(plan, build=build)


def fig7_9_plan(sim_time: Optional[float] = None, seeds=None):
    """convergence.make_plan: algo x variant (OFF/WI) x seed, two GPT-2
    jobs on dumbbell(2, 2) for every algorithm: six groups."""
    return _pinned(convergence.make_plan, sim_time, seeds)


def table2_plan(sim_time: Optional[float] = None, seeds=None):
    """diversity.make_plan: the Table-2 snapshots, scheme x the one-hot
    ``solo`` axis x seed: at most four groups."""
    return _pinned(diversity.make_plan, sim_time, seeds)


def fig10_plan(algo: str, sim_time: Optional[float] = None, seeds=None):
    """speedup_vs_jobs._plan: variant x job count (2-6, padded) x seed on
    dumbbell(n, 2): two groups."""
    return _pinned(lambda: speedup_vs_jobs._plan(
        algo, speedup_vs_jobs.JOB_COUNTS),
                   sim_time, seeds)


def fig12_plan(sim_time: Optional[float] = None, seeds=None):
    """stragglers.make_plan: straggle probability x scheme x seed: two
    groups."""
    return _pinned(stragglers.make_plan, sim_time, seeds)


def fig13_plan(sim_time: Optional[float] = None, seeds=None):
    """partial_compat.make_plan: compute scale x scheme x seed: two
    groups."""
    return _pinned(partial_compat.make_plan, sim_time, seeds)


def fig14_schedule():
    """circular.run's Cassini schedule on the triangle at `depth`'s
    workload scale, and whether it is feasible (the suite's
    ``cassini_has_schedule``; the triangle's loop makes it False)."""
    with _at(*_pin(None, None, False)):
        _, _, sched, feasible = circular._schedule()
    return sched, feasible


def fig14_plan(sim_time: Optional[float] = None, seeds=None):
    """circular.make_plan: scheme (base / MLQCN / Cassini) x seed on the
    triangle: two groups."""
    return _pinned(circular.make_plan, sim_time, seeds)


def fig15_plan(sim_time: Optional[float] = None, seeds=None):
    """parameters.fig15_plan: OFF and WI under each of F1..F6, x seed:
    seven groups."""
    return _pinned(parameters.fig15_plan, sim_time, seeds)


def fig16_plan(sim_time: Optional[float] = None, seeds=None):
    """parameters.fig16_plan: variant x slope x intercept x seed, the OFF
    baseline pruned to the first (S, I): two groups."""
    return _pinned(parameters.fig16_plan, sim_time, seeds)


def fig17_plan(sim_time: Optional[float] = None, seeds=None):
    """parameters.fig17_plan: algo x variant (OFF / WI / MD) x seed: six
    groups."""
    return _pinned(parameters.fig17_plan, sim_time, seeds)


def fig5_spec(sim_time: Optional[float] = None):
    """timeline.telemetry_spec at ``sim_time`` (`depth`'s when None)."""
    return timeline._telemetry_spec(
        depth()["sim_time"] if sim_time is None else sim_time)


def fig5_plan(sim_time: Optional[float] = None, seeds=None):
    """timeline.make_plan: algo x variant x seed; run it with
    ``telemetry=fig5_spec()``."""
    return _pinned(timeline.make_plan, sim_time, seeds)


def kernel_sweep_plan(sim_time: Optional[float] = None, seeds=None):
    """kernel_sweep.make_plan: Reno WI, job count x seed, padded into one
    group."""
    return _pinned(kernel_sweep.make_plan, sim_time, seeds)


def churn_plan(sim_time: Optional[float] = None, seeds=None):
    """churn.make_plan: algo x variant x schedule x seed on the 100 Gbps
    3-job dumbbell, telemetry and faults armed on every point."""
    return _pinned(churn.make_plan, sim_time, seeds, churn_plan=True)


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    name: str
    factory: Callable                        # () -> netsim.Plan
    telemetry: Optional[Callable] = None     # () -> TelemetrySpec, if armed
    lint_unarmed: bool = False               # also lint the unarmed runs


PLANS: dict[str, PlanEntry] = {
    "fig12": PlanEntry("fig12", fig12_plan),
    "fig13": PlanEntry("fig13", fig13_plan),
    # fig5 runs armed (probe rings in the kernel's state); lint both the
    # armed and the unarmed groups: telemetry must not perturb either proof
    "fig5": PlanEntry("fig5", fig5_plan, telemetry=fig5_spec,
                      lint_unarmed=True),
    "kernel_sweep": PlanEntry("kernel_sweep", kernel_sweep_plan),
    # the fault-injection suite: the armed chunk kernel with faults and the
    # re-interleave detector; its configs carry their own telemetry and
    # fault specs, so no telemetry factory here
    "churn": PlanEntry("churn", churn_plan),
}

CI_PLANS = ("fig12", "fig13", "fig5", "kernel_sweep", "churn")

# the figure suites' plans the registry does not lint, by the name the
# figures phase of chip_smoke.py and scripts/reference_plans.py use; each
# builder takes (sim_time, seeds)
FIGURES: dict[str, Callable] = {
    "fig7-9": fig7_9_plan, "table2": table2_plan, "fig13": fig13_plan,
    "fig14": fig14_plan, "fig15": fig15_plan, "fig16": fig16_plan,
    "fig17": fig17_plan, "kernel_sweep": kernel_sweep_plan,
}


def resolve_entry(name: str):
    """-> (plan, telemetry_spec_or_None, lint_unarmed) for a registry
    name, at `depth`'s scale."""
    if name not in PLANS:
        raise KeyError(
            f"unknown plan {name!r}; known: {', '.join(sorted(PLANS))}")
    entry = PLANS[name]
    telemetry = entry.telemetry() if entry.telemetry is not None else None
    return entry.factory(), telemetry, entry.lint_unarmed
