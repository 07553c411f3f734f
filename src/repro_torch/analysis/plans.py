"""Named lintable plans: the figure suites' grids, resolvable without
running them.

The JAX package's registry imports its ``benchmarks/`` suites, which
import that package, so the port keeps its own copies of the five plans
the ``--ci`` gate proves (``CI_PLANS``), built the way
``benchmarks/common.py`` builds a point (`build_cfg`, `protocol`):

* ``fig12``: straggle probability (a sweep field) x base DCQCN / MLQCN /
  Cassini x seed on dumbbell(2, 2) (benchmarks/stragglers.py);
* ``fig13``: compute scale x base DCQCN / MLQCN WI / Static WI with
  `STATIC_FACTORS` x seed on dumbbell(3, 2) (benchmarks/partial_compat.py);
* ``fig5``: algo x OFF/WI x seed, armed with `fig5_spec`'s probes
  (benchmarks/timeline.py); the registry lints it armed and unarmed;
* ``kernel_sweep``: Reno WI, 2 and 3 jobs x seed (benchmarks/
  kernel_sweep.py; the port has no kernel switch, every run takes the
  chunk kernel on the card);
* ``churn``: algo x OFF/WI x fault schedule x seed, with telemetry and
  faults armed on a 100 Gbps 3-job dumbbell (benchmarks/churn.py).

Beside them, ``FIGURES`` holds the other figure suites' plans as plain
builders (no registry entry, no CLI name), which ``chip_smoke.py``'s
``figures`` phase runs on the card: ``fig7-9`` (benchmarks/convergence.py),
``table2`` (diversity.py), ``fig13``, ``fig14`` (circular.py), ``fig15``,
``fig16`` and ``fig17`` (parameters.py) and ``kernel_sweep``.

The depth and the seeds follow ``benchmarks/common.py``: ``REPRO_SMOKE=1``
1.5 s and seed 1, ``REPRO_FULL=1`` 20 s, seeds 1-3 and the unscaled
workload, else 4 s and seeds 1-2 (the churn plan runs 18 s times the
workload scale); `depth` reads them when a plan is built.  Each builder
also takes the depth and seeds explicitly, as ``chip_smoke.py`` calls
them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np

__all__ = ["PlanEntry", "PLANS", "CI_PLANS", "FIGURES", "resolve_entry",
           "depth", "protocol", "build_cfg", "fig7_9_plan", "table2_plan",
           "fig12_plan", "fig13_plan", "fig14_plan", "fig14_schedule",
           "fig15_plan", "fig16_plan", "fig17_plan", "fig5_spec",
           "fig5_plan", "kernel_sweep_plan", "churn_spec", "churn_plan",
           "churn_events", "CHURN_EVENTS", "STATIC_FACTORS", "SOCKETS"]

DT = 2e-5
RTT = 100e-6
# paper §4.1 (slope, intercept) of the WI scheme, benchmarks/common.py (an
# OFF point keeps them: the variant ignores them), and of the MD scheme
PARAMS = {"reno": (1.75, 0.25), "cubic": (1.0, 0.5), "dcqcn": (1.067, 0.267)}
MD_PARAMS = {"reno": (1.0, 1.0), "cubic": (0.8, 0.8),
             "dcqcn": (1.067, 0.267)}
ALGOS = {"reno": 0, "cubic": 1, "dcqcn": 2}
VARIANTS = {"OFF": 0, "WI": 1, "MD": 2}
# ECN thresholds for the RoCE fabric; RED drop thresholds for TCP
RED_BY_ALGO = {
    "reno": dict(red_qmin=150e3, red_qmax=1.5e6, red_pmax=0.12),
    "cubic": dict(red_qmin=150e3, red_qmax=1.5e6, red_pmax=0.12),
    "dcqcn": dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2),
}
# paper §4.1: TCP jobs open parallel sockets, RoCE one QP
SOCKETS = {"reno": 2, "cubic": 2, "dcqcn": 1}

FIG12_PROBS = (0.0, 0.05, 0.10, 0.20, 0.30)
FIG7_ALGOS = ("reno", "cubic", "dcqcn")
TABLE2_JOBS = 2                 # every Table-2 snapshot pairs two jobs
FIG15_SCHEMES = ("OFF", "F1", "F2", "F3", "F4", "F5", "F6")
FIG16_SLOPES = (0.5, 1.0, 1.75, 2.5)
FIG16_INTERCEPTS = (0.1, 0.25, 0.5, 1.0)
FIG17_ALGOS = ("reno", "cubic")
FIG13_COMPUTE_SCALES = (1.5, 1.0, 0.7, 0.45, 0.25)
# Static [67]: fixed per-job factors replacing F (partial_compat.py)
STATIC_FACTORS = np.asarray([1.3, 1.0, 0.7])
FIG5_PROBES = ("flow_cwnd", "flow_rate", "link_queue", "link_mark_rate",
               "job_incomm", "job_iter", "interleave_overlap")
KERNEL_SWEEP_JOBS = (2, 3)
CHURN_JOBS = 3
CHURN_CAP_GBPS = 100.0
CHURN_SCHEDULES = ("gauntlet", "staggered")
# label -> (churned job, blackholed job, arrival, departure, re-arrival,
# blackhole window, flap window and scale), as fractions of the run
CHURN_EVENTS = {
    "gauntlet": (2, 0, 0.08, 0.30, 0.38, (0.18, 0.22), (0.50, 0.64, 0.88)),
    "staggered": (1, 2, 0.10, 0.32, 0.40, (0.20, 0.24), (0.52, 0.66, 0.9)),
}


def depth() -> dict:
    """benchmarks/common.py's scale, read from the environment now:
    ``work_scale``, ``sim_time``, ``seeds`` and the churn plan's
    ``churn_sim_time``."""
    full = bool(int(os.environ.get("REPRO_FULL", "0")))
    smoke = bool(int(os.environ.get("REPRO_SMOKE", "0")))
    scale = 1.0 if full else 0.25
    return dict(work_scale=scale,
                sim_time=20.0 if full else (1.5 if smoke else 4.0),
                seeds=(1, 2, 3) if full else ((1,) if smoke else (1, 2)),
                churn_sim_time=18.0 * scale)


def protocol(algo: str, variant: str = "WI", f_spec: str = "linear"):
    """common.protocol: the algorithm's paper parameters, OFF, WI or MD,
    with the F family ``f_spec``."""
    from repro_torch.core import CCParams, MLTCPConfig

    slope, intercept = (MD_PARAMS if variant == "MD" else PARAMS)[algo]
    return MLTCPConfig(
        cc=CCParams(algo=ALGOS[algo], variant=VARIANTS[variant], tick_dt=DT,
                    rtt=RTT),
        slope=slope, intercept=intercept, f_spec=f_spec)


def build_cfg(topo, profiles, proto, *, sim_time: float, **kw):
    """common.build_cfg: the phase programs scaled by `depth`'s workload
    scale, seed 1, the algorithm's RED/ECN thresholds."""
    from repro_torch import netsim, workload

    scale = depth()["work_scale"]
    jobs = workload.jobspec_from_profiles([p.scaled(scale) for p in profiles])
    algo = {v: k for k, v in ALGOS.items()}[proto.cc.algo]
    return netsim.SimConfig(topo=topo, jobs=jobs, protocol=proto,
                            sim_time=sim_time, dt=DT, seed=1,
                            **{**RED_BY_ALGO[algo], **kw})


def _gpt2(n: int) -> list:
    from repro_torch import workload

    return [workload.profile_for("gpt2") for _ in range(n)]


def _depth(sim_time, seeds) -> tuple[float, tuple]:
    d = depth()
    return (d["sim_time"] if sim_time is None else sim_time,
            tuple(d["seeds"] if seeds is None else seeds))


def fig12_plan(sim_time: Optional[float] = None, seeds=None):
    """stragglers.make_plan: straggle probability (a sweep field) x scheme
    x seed, DCQCN with ECN, the Cassini leaves from
    `workload.cassini_schedule`."""
    from repro_torch import netsim, workload

    sim_time, seeds = _depth(sim_time, seeds)
    topo = netsim.dumbbell(2, sockets_per_job=2)
    profs = _gpt2(2)
    sched, _ = workload.cassini_schedule(
        topo, [p.scaled(depth()["work_scale"]) for p in profs])

    def build(pt):
        variant = "WI" if pt["scheme"] == "mlqcn" else "OFF"
        return build_cfg(topo, profs, protocol("dcqcn", variant),
                         sim_time=sim_time,
                         cassini=sched if pt["scheme"] == "cassini" else None)
    return netsim.Plan(name="fig12", build=build, axes=(
        netsim.Axis("p", FIG12_PROBS, field="straggle_prob"),
        netsim.Axis("scheme", ("base", "mlqcn", "cassini")),
        netsim.Axis("seed", seeds)))


def fig13_plan(sim_time: Optional[float] = None, seeds=None):
    """partial_compat.make_plan: compute scale x scheme x seed, DCQCN on
    dumbbell(3, 2); Static rides the WI group through the adaptive
    sentinel, so the grid is two groups (base OFF, {MLQCN, Static} WI)."""
    from repro_torch import netsim, workload

    sim_time, seeds = _depth(sim_time, seeds)
    topo = netsim.dumbbell(3, sockets_per_job=2)

    def build(pt):
        base = workload.profile_for("gpt2")
        profs = [base.compute_scaled(pt["cs"]) for _ in range(3)]
        variant = "OFF" if pt["scheme"] == "base" else "WI"
        return build_cfg(
            topo, profs, protocol("dcqcn", variant), sim_time=sim_time,
            static_job_factors=(STATIC_FACTORS if pt["scheme"] == "static"
                                else None))
    return netsim.Plan(name="fig13", build=build, axes=(
        netsim.Axis("cs", FIG13_COMPUTE_SCALES),
        netsim.Axis("scheme", ("base", "mlqcn", "static")),
        netsim.Axis("seed", seeds)))


def fig7_9_plan(sim_time: Optional[float] = None, seeds=None):
    """convergence.run: algo x variant (OFF/WI) x seed, two GPT-2 jobs on
    dumbbell(2, 2) for every algorithm (this suite gives DCQCN two
    sockets a job too, unlike fig 5's `SOCKETS`): six groups."""
    from repro_torch import netsim

    sim_time, seeds = _depth(sim_time, seeds)
    topo = netsim.dumbbell(2, sockets_per_job=2)
    profs = _gpt2(2)

    def build(pt):
        return build_cfg(topo, profs, protocol(pt["algo"], pt["variant"]),
                         sim_time=sim_time)
    return netsim.Plan(name="fig7-9", build=build, axes=(
        netsim.Axis("algo", FIG7_ALGOS),
        netsim.Axis("variant", ("OFF", "WI")),
        netsim.Axis("seed", seeds)))


def _solo_mask(v):
    """diversity.run's `solo` resolver: every job, or one job alone."""
    if v == "all":
        return np.ones((TABLE2_JOBS,), bool)
    mask = np.zeros((TABLE2_JOBS,), bool)
    mask[v] = True
    return mask


def _table2_where(pt) -> bool:
    # isolation points only need the baseline protocol
    return pt["solo"] == "all" or pt["scheme"] == "base"


def table2_plan(sim_time: Optional[float] = None, seeds=None):
    """diversity.run: the four `workload.table2_snapshots` on the two-tier
    fabric, scheme (base DCQCN / MLQCN) x the one-hot `solo` axis on
    ``job_active`` x seed, isolation points only under base; the
    snapshots of one phase structure merge, so at most four groups."""
    from repro_torch import netsim, workload

    sim_time, seeds = _depth(sim_time, seeds)
    by_name = {s.name: s for s in workload.table2_snapshots(
        sockets_per_job=2)}

    def build(pt):
        snap = by_name[pt["snap"]]
        variant = "WI" if pt["scheme"] == "mlqcn" else "OFF"
        return build_cfg(snap.topo, list(snap.profiles),
                         protocol("dcqcn", variant), sim_time=sim_time)
    return netsim.Plan(name="table2", build=build, where=_table2_where,
                       axes=(netsim.Axis("snap", tuple(by_name)),
                             netsim.Axis("scheme", ("base", "mlqcn")),
                             netsim.Axis("solo", ("all",)
                                         + tuple(range(TABLE2_JOBS)),
                                         field="job_active",
                                         resolve=_solo_mask),
                             netsim.Axis("seed", seeds)))


def fig14_schedule():
    """circular.run's Cassini schedule for three GPT-2 jobs on the
    triangle, and whether it is feasible (the suite's
    `cassini_has_schedule`; the triangle's loop makes it False)."""
    from repro_torch import netsim, workload

    return workload.cassini_schedule(
        netsim.triangle(sockets_per_job=2),
        [p.scaled(depth()["work_scale"]) for p in _gpt2(3)])


def fig14_plan(sim_time: Optional[float] = None, seeds=None):
    """circular.run: scheme (base DCQCN / MLQCN / Cassini) x seed on
    ``netsim.triangle(2)``; the (infeasible) Cassini schedule rides the
    OFF group's sweep leaves: two groups."""
    from repro_torch import netsim

    sim_time, seeds = _depth(sim_time, seeds)
    topo = netsim.triangle(sockets_per_job=2)
    profs = _gpt2(3)
    sched, _ = fig14_schedule()

    def build(pt):
        variant = "WI" if pt["scheme"] == "mlqcn" else "OFF"
        return build_cfg(topo, profs, protocol("dcqcn", variant),
                         sim_time=sim_time,
                         cassini=sched if pt["scheme"] == "cassini" else None)
    return netsim.Plan(name="fig14", build=build, axes=(
        netsim.Axis("scheme", ("base", "mlqcn", "cassini")),
        netsim.Axis("seed", seeds)))


def fig15_plan(sim_time: Optional[float] = None, seeds=None):
    """parameters.fig15_agg_functions: OFF and WI under each of F1..F6, x
    seed, Reno, three GPT-2 jobs on dumbbell(3, 2): seven groups (the F
    family is static)."""
    from repro_torch import netsim

    sim_time, seeds = _depth(sim_time, seeds)
    topo = netsim.dumbbell(3, sockets_per_job=2)
    profs = _gpt2(3)

    def build(pt):
        s = pt["scheme"]
        proto = (protocol("reno", "OFF") if s == "OFF"
                 else protocol("reno", "WI", f_spec=s))
        return build_cfg(topo, profs, proto, sim_time=sim_time)
    return netsim.Plan(name="fig15", build=build, axes=(
        netsim.Axis("scheme", FIG15_SCHEMES), netsim.Axis("seed", seeds)))


def fig16_plan(sim_time: Optional[float] = None, seeds=None):
    """parameters.fig16_heatmap: variant x slope x intercept x seed, Reno on
    dumbbell(2, 2); S and I are sweep fields, and `where` prunes the OFF
    baseline to the first (S, I): two groups, WI of 4 x 4 x seeds
    points."""
    from repro_torch import netsim

    sim_time, seeds = _depth(sim_time, seeds)
    topo = netsim.dumbbell(2, sockets_per_job=2)
    profs = _gpt2(2)

    def build(pt):
        return build_cfg(topo, profs, protocol("reno", pt["variant"]),
                         sim_time=sim_time)

    def where(pt):
        return pt["variant"] == "WI" or (
            pt["slope"] == FIG16_SLOPES[0]
            and pt["intercept"] == FIG16_INTERCEPTS[0])
    return netsim.Plan(name="fig16", build=build, where=where, axes=(
        netsim.Axis("variant", ("OFF", "WI")),
        netsim.Axis("slope", FIG16_SLOPES),
        netsim.Axis("intercept", FIG16_INTERCEPTS),
        netsim.Axis("seed", seeds)))


def fig17_plan(sim_time: Optional[float] = None, seeds=None):
    """parameters.fig17_wi_vs_md: algo (Reno, CUBIC) x variant (OFF / WI /
    MD) x seed on dumbbell(2, 2): six groups."""
    from repro_torch import netsim

    sim_time, seeds = _depth(sim_time, seeds)
    topo = netsim.dumbbell(2, sockets_per_job=2)
    profs = _gpt2(2)

    def build(pt):
        return build_cfg(topo, profs, protocol(pt["algo"], pt["variant"]),
                         sim_time=sim_time)
    return netsim.Plan(name="fig17", build=build, axes=(
        netsim.Axis("algo", FIG17_ALGOS),
        netsim.Axis("variant", ("OFF", "WI", "MD")),
        netsim.Axis("seed", seeds)))


def fig5_spec(sim_time: Optional[float] = None):
    """timeline.telemetry_spec: the suite's probes, ~1000 samples a run."""
    from repro_torch import netsim

    sim_time = depth()["sim_time"] if sim_time is None else sim_time
    n_ticks = int(round(sim_time / DT))
    return netsim.TelemetrySpec(probes=FIG5_PROBES,
                                stride=max(1, n_ticks // 1000))


def fig5_plan(sim_time: Optional[float] = None, seeds=None):
    """timeline.make_plan: algo x variant x seed, two GPT-2 jobs on
    dumbbell(2, sockets per algo); run it with ``telemetry=fig5_spec()``."""
    from repro_torch import netsim

    sim_time, seeds = _depth(sim_time, seeds)
    profs = _gpt2(2)

    def build(pt):
        algo = pt["algo"]
        return build_cfg(netsim.dumbbell(2, sockets_per_job=SOCKETS[algo]),
                         profs, protocol(algo, pt["variant"]),
                         sim_time=sim_time)
    return netsim.Plan(name="fig5-timeline", build=build, axes=(
        netsim.Axis("algo", tuple(SOCKETS)),
        netsim.Axis("variant", ("OFF", "WI")),
        netsim.Axis("seed", seeds)))


def kernel_sweep_plan(sim_time: Optional[float] = None, seeds=None):
    """kernel_sweep.make_plan: Reno WI, job count x seed on dumbbell(n, 2);
    the job counts pad into one group."""
    from repro_torch import netsim

    sim_time, seeds = _depth(sim_time, seeds)

    def build(pt):
        n = pt["n_jobs"]
        return build_cfg(netsim.dumbbell(n, sockets_per_job=2), _gpt2(n),
                         protocol("reno", "WI"), sim_time=sim_time)
    return netsim.Plan(name="kernel-sweep", build=build, axes=(
        netsim.Axis("n_jobs", KERNEL_SWEEP_JOBS),
        netsim.Axis("seed", seeds)))


def churn_faults():
    """churn.SPEC: 8 event rows, churn, flaps and blackholes."""
    from repro_torch import netsim

    return netsim.FaultSpec(n_events=8, churn=True, link_flaps=True,
                            blackholes=True)


def churn_spec(sim_time: Optional[float] = None):
    """churn.telemetry_spec: overlap and iterations, the three detectors,
    the 0.8 overlap threshold, ~1000 samples a run."""
    from repro_torch import netsim

    sim_time = depth()["churn_sim_time"] if sim_time is None else sim_time
    n_ticks = int(round(sim_time / DT))
    return netsim.TelemetrySpec(
        probes=("interleave_overlap", "job_iter"),
        detectors=("interleave", "iter_sketch", "reinterleave"),
        overlap_threshold=0.8, stride=max(1, n_ticks // 1000))


def churn_events(cfg, label: str) -> list:
    """churn._events: the labeled gauntlet on ``cfg``'s fabric, its times
    fractions of ``cfg.sim_time``."""
    from repro_torch import netsim

    t = cfg.sim_time
    churn_job, bh_job, arr, dep, rearr, bh, flap = CHURN_EVENTS[label]
    bh_flow = [int(f) for f in
               (np.asarray(cfg.topo.flow_to_job) == bh_job).nonzero()[0]][:1]
    return [
        netsim.job_departs(0.0, churn_job),
        netsim.job_arrives(arr * t, churn_job),
        netsim.job_departs(dep * t, churn_job),
        netsim.job_arrives(rearr * t, churn_job),
        netsim.link_flap(flap[0] * t, flap[1] * t, 0, flap[2]),
        netsim.blackhole(bh[0] * t, bh[1] * t, bh_flow),
    ]


def churn_plan(sim_time: Optional[float] = None, seeds=None):
    """churn.make_plan: algo x variant x schedule x seed on the 100 Gbps
    3-job dumbbell, telemetry and faults armed on every point; the schedule
    a ``field="*"`` axis resolving, per point config, to the schedule's
    sweep overrides."""
    from repro_torch import netsim

    d = depth()
    sim_time = d["churn_sim_time"] if sim_time is None else sim_time
    seeds = tuple(d["seeds"] if seeds is None else seeds)
    faults = churn_faults()
    tel = churn_spec(sim_time)

    def build(pt):
        algo = pt["algo"]
        topo = netsim.dumbbell(CHURN_JOBS, sockets_per_job=SOCKETS[algo],
                               cap_gbps=CHURN_CAP_GBPS)
        return build_cfg(topo, _gpt2(CHURN_JOBS),
                         protocol(algo, pt["variant"]), sim_time=sim_time,
                         faults=faults, telemetry=tel)

    def schedule(label):
        return lambda cfg: netsim.fault_schedule(
            cfg, churn_events(cfg, label), spec=faults).overrides()
    return netsim.Plan(name="churn-gauntlet", build=build, axes=(
        netsim.Axis("algo", tuple(SOCKETS)),
        netsim.Axis("variant", ("OFF", "WI")),
        netsim.Axis("schedule", CHURN_SCHEDULES, field="*",
                    resolve=schedule),
        netsim.Axis("seed", seeds)))


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
