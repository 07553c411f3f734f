"""Driver of the simulator's cells: experiment plans through `run_plan`.

One client issues the cell's plan back to back (a closed loop, as a
researcher's sweep script does).  Each plan is the configuration's axes
crossed with the next ``seeds_per_plan`` seeds of the run's stream, so no
two plans of a run repeat a point.  The plan is built through the port's
public API (`netsim.Plan`, `netsim.Axis`, `netsim.dumbbell`,
`netsim.SimConfig`, `workload`, `core`) from the configuration file's
numbers alone.

The end-to-end rate is the point-ticks of every plan the window ran over
the time from the window's start to the end of its last plan.  Once the
window has closed, one of its plans, drawn from the run's seed, is
simulated again by the plain reference (`reference.fluid`) and judged
(`reference.judge`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from harness import spans as spans_mod

# seeds live in int32 (the sweep's seed leaf); a run's stream starts at
# the run's seed folded into [1, SEED_SPAN]
SEED_SPAN = 2 ** 31 - 2 ** 24


def seed_stream(seed: int) -> int:
    """The first simulation seed of a run started with ``--seed seed``."""
    return 1 + int(seed) % SEED_SPAN


def build_plan(cfg: dict, seeds: list[int]):
    """The configuration's plan over ``seeds``, as a `netsim.Plan`."""
    from repro_torch import netsim, workload
    from repro_torch.core import Algo, CCParams, MLTCPConfig, Variant

    job, proto, cc = cfg["job"], cfg["protocol"], cfg["cc"]
    algo = {"reno": Algo.RENO, "dcqcn": Algo.DCQCN}[proto["algo"]]
    profile = workload.CommProfile(
        name=job["model"], compute_s=tuple(job["compute_s"]),
        comm_bytes=tuple(job["comm_bytes"])).scaled(cfg["work_scale"])
    link = cfg["iso_link_gbps"] * netsim.topology.GBPS
    topo_cfg = cfg["topology"]
    if topo_cfg["kind"] != "dumbbell":
        raise ValueError(f"unknown topology {topo_cfg['kind']!r}")

    def build(pt):
        n = int(pt["n_jobs"])
        protocol = MLTCPConfig(
            cc=CCParams(algo=int(algo), variant=int(Variant[pt["variant"]]),
                        **{k: v for k, v in cc.items()}),
            f_spec=proto["f_spec"], slope=proto["slope"],
            intercept=proto["intercept"], favoritism=proto["favoritism"],
            aggregate_by_job=proto["aggregate_by_job"],
            init_comm_gap=proto["init_comm_gap"], g=proto["g"],
            gamma=proto["gamma"])
        jobs = workload.jobspec_from_profiles(
            [profile] * n, straggle_prob=[job["straggle_prob"]] * n,
            link_bytes_per_s=link)
        return netsim.SimConfig(
            topo=netsim.dumbbell(n, sockets_per_job=topo_cfg[
                "sockets_per_job"], cap_gbps=topo_cfg["cap_gbps"]),
            jobs=jobs, protocol=protocol, sim_time=cfg["sim_time"],
            dt=cfg["dt"], red_qmin=cfg["red_qmin"], red_qmax=cfg["red_qmax"],
            red_pmax=cfg["red_pmax"], buffer_bytes=cfg["buffer_bytes"],
            n_chunks=cfg["n_chunks"],
            max_iters_recorded=cfg["max_iters_recorded"], seed=pt["seed"])

    axes = [netsim.Axis(name, tuple(values))
            for name, values in cfg["axes"].items()]
    axes.append(netsim.Axis("seed", tuple(seeds)))
    return netsim.Plan(name=cfg["name"], axes=tuple(axes), build=build)


def plan_points(cfg: dict, seeds: list[int]) -> list[dict]:
    """The plan's points ({axis: value}), in the plan's order (last axis
    fastest), computed without the program."""
    pts = [{}]
    for name, values in list(cfg["axes"].items()) + [("seed", seeds)]:
        pts = [{**p, name: v} for p in pts for v in values]
    return pts


@dataclasses.dataclass
class PlanRecord:
    """What the window keeps of one plan."""

    seeds: list
    t0: float
    t1: float
    point_ticks: int
    group_ticks: int
    execute_s: float
    launches: int
    fallbacks: int
    groups: int
    results: Optional[list] = None
    raws: Optional[list] = None
    shapes: list = dataclasses.field(default_factory=list)
    failed: int = 0          # points of the plan without a result


class Capture:
    """Keeps the raw outputs `metrics.postprocess` is handed for each point
    of the current plan (the seven chunk traces, of which the results keep
    five), by wrapping the module attribute `run_plan` calls."""

    def __init__(self):
        from repro_torch.netsim import metrics

        self.metrics = metrics
        self.original = metrics.postprocess
        self.raws: list = []

        def postprocess(cfg, raw, *args, **kw):
            self.raws.append((kw.get("point"), raw))
            return self.original(cfg, raw, *args, **kw)

        metrics.postprocess = postprocess

    def take(self) -> list:
        out, self.raws = self.raws, []
        return out

    def close(self) -> None:
        self.metrics.postprocess = self.original


def ticks_run(cfg: dict) -> tuple[int, int, int]:
    """(ticks a run steps, ticks a chunk, chunks) of the configuration:
    whole chunks of ``n_ticks // n_chunks`` ticks."""
    n_ticks = int(round(cfg["sim_time"] / cfg["dt"]))
    tpc = max(1, n_ticks // int(cfg["n_chunks"]))
    return (n_ticks // tpc) * tpc, tpc, n_ticks // tpc


def judge_plan(cfg: dict, rec: PlanRecord, n_judged: int, rand) -> dict:
    """The plan ``rec`` against the plain reference: ``n_judged`` of its
    points (all where it has fewer), drawn with ``rand``."""
    from reference import fluid, judge

    points = plan_points(cfg, rec.seeds)
    by_axes = {tuple(sorted(p.axes.items())): raw for p, raw in rec.raws
               if p is not None}
    idx = sorted(rand.sample(range(len(points)),
                             min(n_judged, len(points))))
    chosen = [points[i] for i in idx]
    ref = fluid.simulate(cfg, chosen)
    per_point = []
    for slot, i in enumerate(idx):
        res = rec.results[i]
        raw = by_axes.get(tuple(sorted(points[i].items())))
        n = int(points[i]["n_jobs"])
        if res is None or raw is None or res.point.axes != points[i]:
            per_point.append(judge.missing())
            continue
        per_point.append(judge.compare_point(
            judge.program_view(res, raw, n), fluid.postprocess(ref, slot, n)))
    return judge.judge(per_point, cfg["limits"])


def run(ctx) -> None:
    """Set up and warm up, run the window, then judge a sampled plan."""
    from repro_torch import netsim
    from repro_torch.netsim import counters, engine, experiment, metrics

    cfg, traffic, args = ctx.config, ctx.traffic, ctx.args
    per_plan = int(traffic["seeds_per_plan"])
    dev = ctx.device
    run_ticks, tpc, n_chunks = ticks_run(cfg)
    next_seed = seed_stream(args.seed)

    def take_seeds():
        nonlocal next_seed
        out = list(range(next_seed, next_seed + per_plan))
        next_seed += per_plan
        return out

    capture = Capture()
    ctx.marks["driver"] = time.perf_counter()

    def one_plan(seeds) -> PlanRecord:
        with spans_mod.span(ctx.spans, "build_plan"):
            plan = build_plan(cfg, seeds)
        t0 = time.perf_counter()
        with spans_mod.span(ctx.spans, "run_plan"):
            with counters.watch() as w:
                pr = netsim.run_plan(plan, device=dev)
        t1 = time.perf_counter()
        groups = pr.profile.groups
        return PlanRecord(
            seeds=seeds, t0=t0, t1=t1,
            point_ticks=sum(g.n_points for g in groups) * run_ticks,
            group_ticks=len(groups) * run_ticks,
            execute_s=sum(g.execute_s or 0.0 for g in groups),
            launches=w.launches, fallbacks=w.fallbacks, groups=len(groups),
            results=list(pr.results), raws=capture.take(),
            shapes=[(g.n_points, g.n_flows, g.n_jobs) for g in groups],
            failed=sum(r is None for r in pr.results))

    # set-up: the kernel library and every shape of the cell
    for _ in range(int(traffic.get("warmup_plans", 1))):
        one_plan(take_seeds())
    ctx.sync()
    ctx.marks["warmup"] = time.perf_counter()
    wraps = ((engine, "chunk_inputs", "chunk_inputs"),
             (experiment, "_run_group", "run_group"),
             (metrics, "postprocess", "postprocess"))
    kept = None
    with ctx.window(wraps):
        while True:
            rec = one_plan(take_seeds())
            ctx.plans.append(rec)
            # keep one plan of the window, drawn uniformly with the seed
            if ctx.rand.random() * len(ctx.plans) < 1.0:
                kept = rec
            else:
                rec.results = rec.raws = None
            if rec.t1 - ctx.window_t0 >= args.seconds:
                break
    ctx.end_window(ctx.plans[-1].t1)
    capture.close()

    shapes: dict = {}
    for rec in ctx.plans:
        for k, n, j in rec.shapes:
            shapes[(k, n, j)] = shapes.get((k, n, j), 0) + n_chunks
    ctx.launches = [dict(algo=cfg["protocol"]["algo"], K=k, N=n, M=1, J=j,
                         T=tpc, D=max(1, int(round(cfg["cc"]["rtt"]
                                                   / cfg["dt"]))),
                         P=len(cfg["job"]["compute_s"]), count=c)
                    for (k, n, j), c in shapes.items()]
    groups = sum(r.groups for r in ctx.plans)
    ctx.route = dict(plans=len(ctx.plans), groups=groups,
                     launches=sum(r.launches for r in ctx.plans),
                     launches_expected=groups * n_chunks,
                     fallbacks=sum(r.fallbacks for r in ctx.plans))
    ctx.attempted = sum(len(plan_points(cfg, r.seeds)) for r in ctx.plans)
    ctx.failed = sum(r.failed for r in ctx.plans)

    ctx.free_program()
    t0 = time.perf_counter()
    ctx.verdict = judge_plan(cfg, kept, int(traffic["judged_points"]),
                             ctx.rand)
    ctx.reference_s = time.perf_counter() - t0
