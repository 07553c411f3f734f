"""Declarative experiment plans — one sweep surface over every axis.

The paper's evaluation is a matrix of sweeps: Fig. 10 varies job count x
seed, Figs. 15-17 vary aggressiveness functions and protocol scalars, the
baselines add scheme axes (OFF / WI / MD / Static / Cassini).  Some of those
axes are *dynamic* (values the batched sweep carries on its leading [K]
axis: slope, intercept, g, gamma, RED thresholds, seeds, per-job workload
values and factors, the ``job_active`` mask) and some are *static* (they
shape the run: algorithm, variant, F family, topology, job structure).
Callers declare a `Plan`:

    plan = Plan(
        name="fig10-reno",
        axes=(Axis("variant", ("OFF", "WI")),
              Axis("n_jobs", (2, 3, 4, 5, 6, 7, 8)),
              Axis("seed", (1, 2, 3))),
        build=lambda pt: build_cfg_for(pt["variant"], pt["n_jobs"]),
    )
    result = run_plan(plan)
    sweep_speedup_stats(result.select(variant="OFF", n_jobs=4),
                        result.select(variant="WI", n_jobs=4))

and `run_plan` does the partitioning, as the reference does:

  1. enumerate the cartesian product of the axes (minus `where`-filtered
     points) and build each point's `SimConfig`;
  2. group points by *static signature*: the config with every dynamic
     field canonicalized, so points that differ only dynamically share one
     compile group;
  3. merge groups that differ only in workload *shape*: if a point's
     (topology, job structure) equals the *restriction* of a larger point's
     to its first n jobs, the smaller point runs on the larger fabric with
     a ``job_active`` mask (the padded-jobs axis); phase programs are
     column-padded to the group's P_max (zero columns are inert under the
     ``n_phases`` mask);
  4. run each group's points as one `simulate_sweep` of K points: on the
     card one `ChunkRun` of the chunk kernel, one launch per chunk of
     ticks for all K points;
  5. post-process each point with its own (unpadded) config and attach a
     `SweepPoint`, so every `SimResult` names its axis coordinates.

The port compiles nothing per group (the kernels are built once per
process), so a "compile group" is one batched run.  Grouping still
decides how many runs a plan costs, and it matches the reference's group
for group.

``run_plan(..., cache_dir=...)`` adds a SweepPoint-keyed on-disk cache:
each point's result is stored under a content hash of its full config and
resolved dynamic overrides, so interrupted runs resume and figures
re-aggregate without re-simulating.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import pickle
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import mltcp_step as ms
from repro_torch.kernels import netsim_chunk as nc
from repro_torch.kernels import ops as kernel_ops
from repro_torch.netsim import counters
from repro_torch.netsim import metrics
from repro_torch.netsim.engine import (
    JobSpec,
    SimConfig,
    SweepParams,
    SweepPoint,
    _FIELD_DTYPE,
    _point_shape,
    point_of,
    simulate_sweep,
    sweep_of,
    tree_map,
)
from repro_torch.netsim.telemetry import TelemetrySpec
from repro_torch.netsim.topology import Topology

__all__ = ["Axis", "Plan", "PlanResult", "GroupError", "GroupProfile",
           "PlanProfile", "run_plan", "prune_cache", "restrict_workload",
           "resolve_plan", "group_sweep"]

Tensor = torch.Tensor

# the fields a dynamic axis may target (the fault schedule's included)
_DYNAMIC_FIELDS = frozenset(SweepParams._fields)


# ---------------------------------------------------------------------------
# Plan declaration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Axis:
    """One named dimension of an experiment plan.

    ``values`` are the labels enumerated into the cartesian product; every
    point's full label dict is passed to `Plan.build`.

    kind:
      * "dynamic" — the axis targets a `SweepParams` field and rides the
        batched sweep (no new run across its values);
      * "static"  — the axis only shapes the config via `Plan.build`
        (algorithm, variant, F family, workload, ...);
      * "auto"    — dynamic iff the target field names a SweepParams field.

    ``field`` overrides the targeted SweepParams field (default: the axis
    name), and ``resolve`` maps a label to the field's actual value — e.g.
    an axis named "solo" with values ("all", 0, 1) can resolve to
    `job_active` masks while results stay selectable by the human label.

    ``field="*"`` targets *several* sweep fields at once: the resolved
    value must be a ``{sweep field: value}`` dict — or a callable taking
    the point's built `SimConfig` and returning one, for values whose
    shapes depend on the config (a fault schedule's blackhole table is
    [E, n_flows], and n_flows follows the point's fabric).  A fault
    schedule axis is the canonical use: one label resolves to the whole
    ``faults.FaultSchedule.overrides()`` dict.
    """

    name: str
    values: tuple
    kind: str = "auto"
    field: Optional[str] = None
    resolve: Optional[Callable[[object], object]] = None

    def __post_init__(self):
        if self.kind not in ("auto", "dynamic", "static"):
            raise ValueError(f"axis {self.name!r}: unknown kind {self.kind!r}")
        if not len(self.values):
            raise ValueError(f"axis {self.name!r} has no values")
        object.__setattr__(self, "values", tuple(self.values))

    @property
    def target(self) -> str:
        return self.field if self.field is not None else self.name

    def is_dynamic(self) -> bool:
        if self.kind == "auto":
            return self.target == "*" or self.target in _DYNAMIC_FIELDS
        return self.kind == "dynamic"


@dataclasses.dataclass(frozen=True)
class Plan:
    """A declarative experiment: named axes x a config-building function.

    ``build`` receives one point's ``{axis name: value}`` dict and returns
    that point's `SimConfig`.  It may ignore dynamic axes entirely —
    `run_plan` threads their (resolved) values into the sweep afterwards —
    but static axes (job count, scheme, F family, ...) must be reflected in
    the returned config.  ``where`` optionally prunes points from the
    cartesian product (e.g. baseline points that only need one slope).
    """

    axes: tuple[Axis, ...]
    build: Callable[[dict], SimConfig]
    name: str = ""
    where: Optional[Callable[[dict], bool]] = None

    def __post_init__(self):
        names = [ax.name for ax in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"plan {self.name!r}: duplicate axis names {names}")

    def points(self) -> list[dict]:
        """The cartesian product of axis values (last axis fastest), minus
        `where`-filtered points, as one label dict per point."""
        pts = [{}]
        for ax in self.axes:
            pts = [{**p, ax.name: v} for p in pts for v in ax.values]
        if self.where is not None:
            pts = [p for p in pts if self.where(p)]
        if not pts:
            raise ValueError(f"plan {self.name!r} has no points")
        return pts


# ---------------------------------------------------------------------------
# Workload restriction — the padded-jobs merge test
# ---------------------------------------------------------------------------

def restrict_workload(topo: Topology, jobs: JobSpec,
                      n_jobs: int) -> tuple[Topology, JobSpec]:
    """The sub-workload on the first ``n_jobs`` jobs of a fabric.

    A smaller plan point may run on a larger point's fabric (with trailing
    jobs masked off) exactly when its own (topo, jobs) equal this
    restriction — same links, same flows for the kept jobs, same phase
    programs.  Flows of kept jobs must form a prefix of the flow axis so
    the lane-stable draws (`netsim.random`) give them the same randomness.
    """
    keep = topo.flow_to_job < n_jobs
    topo_r = Topology(cap=topo.cap, hops=topo.hops[keep],
                      flow_to_job=topo.flow_to_job[keep], names=topo.names)
    jobs_r = JobSpec(compute=jobs.compute[:n_jobs],
                     comm_bytes=jobs.comm_bytes[:n_jobs],
                     n_phases=jobs.n_phases[:n_jobs],
                     start_offset=jobs.start_offset[:n_jobs],
                     straggle_prob=jobs.straggle_prob[:n_jobs],
                     iso_iter_time=jobs.iso_iter_time[:n_jobs])
    return topo_r, jobs_r


def _pad_cols(a: np.ndarray, width: int, fill) -> np.ndarray:
    if a.shape[1] >= width:
        return a
    pad = np.full((a.shape[0], width - a.shape[1]), fill, a.dtype)
    return np.concatenate([a, pad], axis=1)


def _same_workload(ta: Topology, ja: JobSpec, tb: Topology, jb: JobSpec) -> bool:
    """Value equality modulo behaviour-neutral padding (zero phase columns,
    -1 hop columns)."""
    if ta.names != tb.names or not np.array_equal(ta.cap, tb.cap):
        return False
    if not np.array_equal(ta.flow_to_job, tb.flow_to_job):
        return False
    h = max(ta.hops.shape[1], tb.hops.shape[1])
    if not np.array_equal(_pad_cols(ta.hops, h, -1), _pad_cols(tb.hops, h, -1)):
        return False
    p = max(ja.compute.shape[1], jb.compute.shape[1])
    return (np.array_equal(_pad_cols(ja.compute, p, 0.0),
                           _pad_cols(jb.compute, p, 0.0))
            and np.array_equal(_pad_cols(ja.comm_bytes, p, 0.0),
                               _pad_cols(jb.comm_bytes, p, 0.0))
            and np.array_equal(ja.n_phases, jb.n_phases)
            and np.array_equal(ja.start_offset, jb.start_offset)
            and np.array_equal(ja.straggle_prob, jb.straggle_prob)
            and np.array_equal(ja.iso_iter_time, jb.iso_iter_time))


def _flows_are_job_prefix(topo: Topology, n_jobs: int) -> bool:
    """Flows of the first n_jobs jobs occupy the first flow lanes."""
    keep = topo.flow_to_job < n_jobs
    return bool(np.all(np.nonzero(keep)[0] == np.arange(int(keep.sum()))))


# ---------------------------------------------------------------------------
# Static signatures & compile groups
# ---------------------------------------------------------------------------

def _canonical_jobs(jobs: JobSpec) -> JobSpec:
    """The job structure with every swept workload value zeroed.

    Phase-program values, straggle probabilities and isolation times ride
    the sweep (`SweepParams.compute` / `comm_bytes` / `straggle_prob` /
    `iso_iter`); only the array shapes, `n_phases` and `start_offset`
    remain structural.
    """
    return JobSpec(compute=np.zeros_like(jobs.compute),
                   comm_bytes=np.zeros_like(jobs.comm_bytes),
                   n_phases=jobs.n_phases,
                   start_offset=jobs.start_offset,
                   straggle_prob=np.zeros_like(jobs.straggle_prob),
                   iso_iter_time=np.zeros_like(jobs.iso_iter_time))


def _canonical_cfg(cfg: SimConfig) -> SimConfig:
    """The config with every dynamic field pinned to a canonical value.

    Two points share a compile group iff their canonical configs are equal
    (after workload-shape merging).

    The Static factors and the Cassini schedule canonicalize to None —
    their values are `SweepParams` leaves and their *presence* is
    normalized per group at lowering time (`_point_params`): a point
    without factors gets the all-negative "adaptive" sentinel, a point
    without a schedule gets all-zero periods (per-job off), both exact
    value-level no-ops in the tick.
    """
    proto = dataclasses.replace(cfg.protocol, slope=0.0, intercept=0.0,
                                g=0.0, gamma=0.0, init_comm_gap=0.0)
    return dataclasses.replace(
        cfg, protocol=proto, seed=0,
        red_qmin=0.0, red_qmax=1.0, red_pmax=0.0,
        jobs=_canonical_jobs(cfg.jobs),
        static_job_factors=None, cassini=None)


def _no_workload(cfg: SimConfig) -> SimConfig:
    return dataclasses.replace(cfg, topo=None, jobs=None)


def _fabric_key(topo: Topology):
    return (topo.names, topo.cap.tobytes())


def _factors_need_split(cfg: SimConfig) -> bool:
    """True when Static-factor presence may not be mixed in one group.

    The reference's rule for a config with ``use_pallas_kernel=True``: its
    kernel's adaptive branch (which the sentinel factor entries select)
    implements only the default linear F over largest_data_sent, so under
    any other F family or favoritism policy a group keeps factor-bearing
    and adaptive points apart.  The port's CC kernels compute F1..F6 too,
    but keep the rule, so that a plan's groups stay the reference's group
    for group.
    """
    return (cfg.protocol.f_spec != "linear"
            or cfg.protocol.favoritism != "largest_data_sent")


@dataclasses.dataclass
class _Group:
    """One compile group: a shared static config + its member points."""

    cfg: SimConfig               # canonical static config (largest fabric,
    #                              phase programs padded to the group P_max)
    idxs: list[int]              # plan-point indices, in plan order
    masked: bool                 # True iff job_active masks are needed
    factors: bool = False        # some member carries Static factors
    cassini: bool = False        # some member carries a Cassini schedule


def _pad_group_jobs(jobs: JobSpec, p_max: int) -> JobSpec:
    if jobs.compute.shape[1] >= p_max:
        return jobs
    return JobSpec(compute=_pad_cols(jobs.compute, p_max, 0.0),
                   comm_bytes=_pad_cols(jobs.comm_bytes, p_max, 0.0),
                   n_phases=jobs.n_phases,
                   start_offset=jobs.start_offset,
                   straggle_prob=jobs.straggle_prob,
                   iso_iter_time=jobs.iso_iter_time)


def _finish_group(cfgs: list[SimConfig], cfg_g: SimConfig,
                  members: list[int], masked: bool) -> _Group:
    p_max = max(cfgs[i].jobs.compute.shape[1] for i in members)
    if cfg_g.jobs.compute.shape[1] < p_max:
        cfg_g = dataclasses.replace(
            cfg_g, jobs=_pad_group_jobs(cfg_g.jobs, p_max))
    return _Group(cfg=cfg_g, idxs=sorted(members), masked=masked,
                  factors=any(cfgs[i].static_job_factors is not None
                              for i in members),
                  cassini=any(cfgs[i].cassini is not None for i in members))


def _compile_groups(cfgs: list[SimConfig], pad_jobs: bool) -> list[_Group]:
    canon = [_canonical_cfg(c) for c in cfgs]
    # Bucket by everything except the workload, then merge by workload
    # *shape* (the canonical jobs' zeroed values make `_same_workload` a
    # structural comparison).  Factor presence joins the key only when the
    # kernel cannot take the adaptive sentinel (_factors_need_split).
    buckets: dict = {}
    for i, c in enumerate(canon):
        fp = (cfgs[i].static_job_factors is not None
              if _factors_need_split(c) else None)
        if pad_jobs:
            key = ("pad", _no_workload(c), _fabric_key(c.topo), fp)
        else:
            key = ("exact", c, fp)
        buckets.setdefault(key, []).append(i)

    groups: list[_Group] = []
    for key, idxs in buckets.items():
        if key[0] == "exact":
            groups.append(_finish_group(cfgs, canon[idxs[0]], idxs,
                                        masked=False))
            continue
        remaining = list(idxs)
        while remaining:
            ref = max(remaining,
                      key=lambda i: (cfgs[i].jobs.n_jobs, cfgs[i].topo.n_flows))
            ref_topo, ref_jobs = cfgs[ref].topo, canon[ref].jobs
            members, rest = [], []
            for i in remaining:
                n = cfgs[i].jobs.n_jobs
                if (n <= ref_jobs.n_jobs
                        and _flows_are_job_prefix(ref_topo, n)
                        and _same_workload(*restrict_workload(ref_topo,
                                                              ref_jobs, n),
                                           cfgs[i].topo, canon[i].jobs)):
                    members.append(i)
                else:
                    rest.append(i)
            masked = any(cfgs[i].jobs.n_jobs < ref_jobs.n_jobs
                         for i in members)
            groups.append(_finish_group(cfgs, canon[ref], members, masked))
            remaining = rest
    # deterministic group order: by first member point
    groups.sort(key=lambda g: g.idxs[0])
    return groups


# ---------------------------------------------------------------------------
# Lowering a group onto the sweep axis
# ---------------------------------------------------------------------------

def _pad_rows(x: Tensor, j: int, fill) -> Tensor:
    if x.shape[0] >= j:
        return x
    pad = torch.full((j - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype)
    return torch.cat([x, pad], dim=0)


def _pad_tensor_cols(x: Tensor, width: int, fill) -> Tensor:
    if x.shape[1] >= width:
        return x
    pad = torch.full((x.shape[0], width - x.shape[1]), fill, dtype=x.dtype)
    return torch.cat([x, pad], dim=1)


def _host(value) -> np.ndarray:
    if isinstance(value, Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _point_params(cfg: SimConfig, overrides: dict,
                  group: _Group) -> SweepParams:
    """Resolve one point's unbatched SweepParams on the group's fabric, on
    the CPU (`_stack_params` moves the group to its device).

    Scalar overrides of per-job fields broadcast across the point's own
    jobs; the workload leaves are then padded to the group's [J_ref, P_max]
    shape (zero rows for masked-off jobs, zero columns beyond `n_phases`);
    Static-factor / Cassini presence is normalized group-wide with exact
    value-level no-ops (the adaptive sentinel, zero periods).
    """
    params = sweep_of(cfg, device="cpu")
    for field, value in overrides.items():
        dtype = _FIELD_DTYPE.get(field, torch.float32)
        a = _host(value)
        shape = _point_shape(field, cfg)
        if a.ndim < len(shape):
            a = np.broadcast_to(a, shape)
        params = params._replace(**{field: torch.as_tensor(
            np.array(a), dtype=dtype)})
    j_ref = group.cfg.jobs.n_jobs
    p_max = group.cfg.jobs.compute.shape[1]
    n = cfg.jobs.n_jobs

    def pad(x, fill=0.0, cols=False):
        x = torch.as_tensor(x, dtype=torch.float32)
        if cols:
            x = _pad_tensor_cols(x, p_max, 0.0)
        return _pad_rows(x, j_ref, fill)

    params = params._replace(
        compute=pad(params.compute, cols=True),
        comm_bytes=pad(params.comm_bytes, cols=True),
        straggle_prob=pad(params.straggle_prob),
        iso_iter=pad(params.iso_iter),
    )
    if group.factors:
        f = params.static_job_factors
        f = torch.full((n,), -1.0) if f is None else f  # adaptive sentinel
        params = params._replace(static_job_factors=pad(f, fill=1.0))
    if group.cassini:
        off = params.cassini_offset
        per = params.cassini_period
        eps = params.cassini_eps
        off = torch.zeros((n,)) if off is None else off
        per = torch.zeros((n,)) if per is None else per
        params = params._replace(
            cassini_offset=pad(off), cassini_period=pad(per),
            cassini_eps=torch.as_tensor(0.0 if eps is None else eps,
                                        dtype=torch.float32))
    if params.job_active is not None:
        m = params.job_active.to(torch.bool)
        if m.shape[0] < j_ref:     # caller mask on the point's own fabric
            m = _pad_rows(m, j_ref, False)
        params = params._replace(job_active=m)
    elif group.masked:
        mask = torch.zeros((j_ref,), dtype=torch.bool)
        mask[:n] = True
        params = params._replace(job_active=mask)
    if cfg.faults is not None:
        # fault tables are built on the point's own fabric; pad the job /
        # flow axis to the group's with identity values (inactive jobs
        # stay inactive, padded flows never blackhole).  Links are never
        # padded: the pad-merge requires an identical link fabric.
        n_flows_g = group.cfg.topo.n_flows
        for fname, width, fill in (("fault_job_active", j_ref, False),
                                   ("fault_straggle", j_ref, 0.0),
                                   ("fault_blackhole", n_flows_g, False)):
            v = getattr(params, fname)
            if v is not None:
                params = params._replace(**{fname: torch.as_tensor(
                    _pad_cols(_host(v), width, fill))})
    return params


def _stack_params(per_point: list[SweepParams], device) -> SweepParams:
    """The points' params as one [K]-batched sweep, every leaf on
    ``device``."""
    out = {}
    for name in SweepParams._fields:
        vals = [getattr(p, name) for p in per_point]
        if all(v is None for v in vals):
            out[name] = None
        elif any(v is None for v in vals):
            raise ValueError(f"sweep field {name!r} set on only some points "
                             f"of one compile group")
        else:
            out[name] = torch.stack(vals).to(device).contiguous()
    return SweepParams(**out)


def _shard_sweep(sweep: SweepParams, k: int,
                 shard) -> tuple[SweepParams, int]:
    """Where the reference lays the K axis across local devices.

    The port runs every group on the one card its sweep lies on, whatever
    ``shard`` says ("auto", True or False): with one card (or on the CPU)
    that is what the reference does too.  Splitting K across several
    cards is not implemented; no run on several cards has checked it.
    """
    return sweep, k


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GroupProfile:
    """Runtime profile of one compile group's run.

    The reference's fields, with their meaning on the port: nothing is
    traced, so ``trace_s`` is 0.0; ``compile_s`` is the time spent
    building or loading the group's kernel library (0 once it is loaded in
    the process); ``execute_s`` and ``wall_s`` come from the host clock
    around the synchronized run (``wall_s`` includes ``compile_s``);
    ``device_bytes`` is the card memory the run added at its peak (under
    ``run_plan(..., profile=True)``, which resets the card's peak
    statistic per group; None on the CPU and otherwise);
    ``cost_envelope`` (under ``profile=True``) is the group's launch
    envelope, `analysis.budget.group_envelope`: the chunk kernel's CTAs,
    threads, shared memory, launches, operand and trace bytes and, on the
    card, its registers and spills, in the leaves `analysis/budgets.json`
    pins (None for a group that does not take the chunk kernel).
    ``traced`` is True for a group that ran.
    """

    n_points: int                     # K on the sweep axis
    n_jobs: int                       # group fabric size (padded)
    n_flows: int
    n_ticks: int                      # per simulation
    wall_s: float                     # end-to-end (load + execute)
    traced: bool
    trace_s: Optional[float] = None
    compile_s: Optional[float] = None
    execute_s: Optional[float] = None
    device_bytes: Optional[int] = None
    cost_envelope: Optional[dict] = None
    signature: Optional[str] = None   # _group_signature


@dataclasses.dataclass
class PlanProfile:
    """Per-group runtime profiles of one `run_plan` call."""

    groups: list[GroupProfile] = dataclasses.field(default_factory=list)

    @property
    def total_wall_s(self) -> float:
        return sum(g.wall_s for g in self.groups)

    @property
    def total_ticks(self) -> int:
        """Simulator ticks across every group (K * n_ticks summed)."""
        return sum(g.n_points * g.n_ticks for g in self.groups)

    def summary(self) -> dict:
        out = {"n_groups": len(self.groups),
               "wall_s": round(self.total_wall_s, 3),
               "n_traced": sum(g.traced for g in self.groups)}
        if any(g.compile_s is not None for g in self.groups):
            out["trace_s"] = round(sum(g.trace_s or 0.0
                                       for g in self.groups), 3)
            out["compile_s"] = round(sum(g.compile_s or 0.0
                                         for g in self.groups), 3)
            out["execute_s"] = round(sum(g.execute_s or 0.0
                                         for g in self.groups), 3)
        mem = [g.device_bytes for g in self.groups
               if g.device_bytes is not None]
        if mem:
            out["peak_group_device_bytes"] = max(mem)
        return out


@dataclasses.dataclass
class GroupError:
    """One compile group's failure under ``run_plan(keep_going=True)``.

    ``signature`` names the group structurally (fabric size, algorithm,
    dt) and ``point_labels`` carry the member points' axis coordinates, so
    a salvaged run's report says exactly which cells are missing and why;
    ``error`` is the stringified exception.
    """

    group_index: int
    signature: str
    point_labels: list[str]
    error: str


def _group_signature(group: _Group) -> str:
    c = group.cfg
    return (f"jobs={c.jobs.n_jobs} flows={c.topo.n_flows} "
            f"algo={c.protocol.cc.algo} dt={c.dt} "
            f"faults={c.faults is not None}")


@dataclasses.dataclass
class PlanResult:
    """All of a plan's results, each self-describing via its `SweepPoint`.

    Results are in plan-point order (cartesian product, last axis fastest).
    ``select`` filters by axis values *preserving that order*, so two
    selections that differ only in a scheme axis stay seed-paired for
    `sweep_speedup_stats`.

    Under ``run_plan(keep_going=True)`` a failed compile group leaves its
    members' slots as None and appends a `GroupError` to ``group_errors``;
    ``select`` / ``group_by`` skip the missing cells.
    """

    plan: Plan
    results: list[metrics.SimResult]
    n_compile_groups: int
    # CC ticks routed through core.cc_tick plus runs on the card sent down
    # the per-tick path while running this plan (`counters.fallbacks`)
    n_kernel_fallbacks: int = 0
    # points served from run_plan's cache_dir (0 without a cache);
    # n_compile_groups counts only the groups actually simulated.
    n_cache_hits: int = 0
    # per-group runtime profile
    profile: PlanProfile = dataclasses.field(default_factory=PlanProfile)
    # compile groups that failed under keep_going=True (empty otherwise —
    # the default keep_going=False re-raises at the failing group)
    group_errors: list[GroupError] = dataclasses.field(default_factory=list)
    # chunk-kernel launches while running this plan (`counters.launches`;
    # 0 on the CPU)
    n_kernel_launches: int = 0

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, i):
        return self.results[i]

    def select(self, **axis_values) -> list[metrics.SimResult]:
        """Results whose SweepPoint matches every given axis=value."""
        out = [r for r in self.results
               if r is not None and r.point.matches(**axis_values)]
        if not out:
            raise KeyError(f"no plan point matches {axis_values} "
                           f"(axes: {[a.name for a in self.plan.axes]})")
        return out

    def group_by(self, *names) -> dict[tuple, list[metrics.SimResult]]:
        """Pivot results by the given axis names -> ordered result lists."""
        out: dict[tuple, list[metrics.SimResult]] = {}
        for r in self.results:
            if r is None:
                continue
            key = tuple(r.point[n] for n in names)
            out.setdefault(key, []).append(r)
        return out

    @property
    def n_ticks(self) -> int:
        """Total simulator ticks executed (for µs/tick accounting)."""
        return sum(r.cfg.n_ticks for r in self.results if r is not None)


# ---------------------------------------------------------------------------
# On-disk point cache (resumable runs)
# ---------------------------------------------------------------------------

# Array dtype kinds the cache key encodes bit-for-bit.  Everything else —
# object arrays most importantly — is rejected loudly: ``tobytes()`` on an
# object array serializes *pointers*, which are unique per process, so a
# silently-coerced leaf would make every run a cache miss (or worse, a
# collision if the allocator reuses addresses).
_HASHABLE_KINDS = frozenset("biufcSU")  # bool/int/uint/float/complex/bytes/str


def _canonical_float_array(a: np.ndarray) -> np.ndarray:
    """Float arrays with every NaN rewritten to the canonical quiet NaN.

    IEEE NaNs carry payload/sign bits that `tobytes` would leak into the
    key: two logically-identical configs built via different code paths
    (e.g. 0/0 vs float("nan")) could hash apart and silently re-simulate.
    Distinct *positions* of NaN still produce distinct keys — only the
    bit-pattern within each NaN is normalized.
    """
    if a.dtype.kind not in "fc" or not np.isnan(a).any():
        return a
    a = a.copy()
    a[np.isnan(a)] = np.nan
    return a


def _stable_bytes(obj, out: list) -> None:
    """Deterministic byte serialization for cache keys (hash() is salted
    per process, so HashableConfig hashes cannot key an on-disk cache).

    Non-finite floats are encoded explicitly (every NaN bit-pattern maps to
    one token; +/-inf keep their signs), a tensor is encoded as its numpy
    array, and array leaves must be of a plainly-hashable dtype — anything
    that numpy would coerce to an object array raises instead of producing
    a pointer-dependent key.  Python floats are encoded as float64 bytes:
    a canonical byte form, no arithmetic.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        out.append(repr(obj).encode())
    elif isinstance(obj, float):
        if math.isnan(obj):
            out.append(b"f:nan")
        elif math.isinf(obj):
            out.append(b"f:+inf" if obj > 0 else b"f:-inf")
        else:
            out.append(np.float64(obj).tobytes())
    elif isinstance(obj, Tensor):
        _stable_bytes(_host(obj), out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.kind not in _HASHABLE_KINDS:
            raise TypeError(
                f"cache key leaf is a {obj.dtype} array; only "
                f"bool/int/float/complex/str arrays have a stable byte "
                f"encoding (object arrays would hash their pointers)")
        out.append(f"nd{obj.dtype}{obj.shape}".encode())
        out.append(np.ascontiguousarray(_canonical_float_array(obj))
                   .tobytes())
    elif isinstance(obj, (list, tuple)):
        out.append(f"seq{len(obj)}".encode())
        for v in obj:
            _stable_bytes(v, out)
    elif isinstance(obj, dict):
        out.append(f"map{len(obj)}".encode())
        for k in sorted(obj):
            _stable_bytes(k, out)
            _stable_bytes(obj[k], out)
    elif dataclasses.is_dataclass(obj):
        out.append(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            _stable_bytes(f.name, out)
            _stable_bytes(getattr(obj, f.name), out)
    else:
        arr = np.asarray(obj)
        if arr.dtype.kind not in _HASHABLE_KINDS:
            raise TypeError(
                f"cache key leaf of type {type(obj).__name__} has no "
                f"stable byte encoding (coerces to a {arr.dtype} array)")
        _stable_bytes(arr, out)


# Result-schema version: bump whenever the pickled `SimResult` payload
# changes shape (new fields, changed semantics).  It salts the content hash
# AND prefixes the filename, so entries written under another schema are
# never deserialized — they simply miss — and `prune_cache` can evict them
# by name without unpickling anything.  The port's keys and filenames
# carry their own prefix, so a cache directory the reference wrote is
# never served to the port.  Version 2: results carry their telemetry,
# and the key covers the telemetry and fault specs and schedules.
_SCHEMA_VERSION = 2
_SCHEMA = f"torch-v{_SCHEMA_VERSION}"


def _point_cache_key(cfg: SimConfig, overrides: dict) -> str:
    """Content hash of everything that determines one point's result: the
    result-schema version, the point's full (uncanonicalized) config and
    its resolved dynamic overrides.  Deliberately *not* a function of the
    group the point lands in — padded runs equal unpadded ones bitwise —
    so cached results survive regrouping (new axis values, pad_jobs
    toggles).
    """
    out: list = [f"repro-torch-plan-cache-{_SCHEMA}".encode()]
    _stable_bytes(cfg, out)
    _stable_bytes({k: _host(v) for k, v in overrides.items()}, out)
    return hashlib.sha256(b"".join(out)).hexdigest()[:32]


def _cache_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{_SCHEMA}-{key}.pkl")


def prune_cache(cache_dir: str) -> int:
    """Evict cache entries written under another result schema (the
    reference's included).

    Stale entries are already unreachable (the schema salts the key and
    prefixes the filename), so this only reclaims disk; returns the number
    of files removed.  Torn `.tmp` leftovers, quarantined ``*.corrupt``
    entries and zero-byte current-schema entries (a crash between `open`
    and the first write of some other tool — `_cache_save` itself is
    atomic) are pruned too; healthy current-schema entries are kept.
    """
    prefix = f"{_SCHEMA}-"
    removed = 0
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    for name in names:
        path = os.path.join(cache_dir, name)
        stale_pkl = name.endswith(".pkl") and not name.startswith(prefix)
        zero_byte = False
        if name.endswith(".pkl") and not stale_pkl:
            try:
                zero_byte = os.path.getsize(path) == 0
            except OSError:
                pass
        if (stale_pkl or name.endswith(".tmp") or name.endswith(".corrupt")
                or zero_byte):
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
    return removed


# Corrupt-entry paths already warned about this process (warn once per
# entry, not once per plan re-run).
_QUARANTINE_WARNED: set = set()


def _cache_load(cache_dir: str, key: str) -> Optional[metrics.SimResult]:
    path = _cache_path(cache_dir, key)
    try:
        f = open(path, "rb")
    except OSError:
        return None         # missing: a plain cache miss
    try:
        with f:
            if os.fstat(f.fileno()).st_size == 0:
                raise pickle.UnpicklingError("zero-byte cache entry")
            return pickle.load(f)
    except Exception:
        # Unreadable / truncated / schema-drifted entry: quarantine it
        # (rename to *.corrupt, so the next resume of this plan doesn't
        # trip over it again and `prune_cache` can reclaim it), warn once,
        # and treat as a miss — a corrupt entry must never crash a
        # resumable run.
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        if path not in _QUARANTINE_WARNED:
            _QUARANTINE_WARNED.add(path)
            warnings.warn(
                f"quarantined corrupt plan-cache entry {path} -> *.corrupt;"
                f" the point will be re-simulated", RuntimeWarning)
        return None


def _cache_save(cache_dir: str, key: str, res: metrics.SimResult) -> None:
    # the attached params are CPU tensors (`_point_params`), so unpickling
    # never needs a card
    path = _cache_path(cache_dir, key)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(res, f)
    os.replace(tmp, path)   # atomic: a crash never leaves a torn entry


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

def _stamp_telemetry(cfgs: list[SimConfig],
                     telemetry: Optional[TelemetrySpec]) -> list[SimConfig]:
    """Every point's config with ``telemetry`` armed (unchanged for None),
    before grouping and before the cache keys."""
    if telemetry is None:
        return cfgs
    if not isinstance(telemetry, TelemetrySpec):
        raise TypeError(f"telemetry must be a TelemetrySpec or None, not "
                        f"{type(telemetry).__name__}")
    return [dataclasses.replace(c, telemetry=telemetry) for c in cfgs]


def _resolve_overrides(plan: Plan, points: list[dict],
                       cfgs: list[SimConfig]) -> list[dict]:
    """Each point's resolved dynamic-axis overrides ({sweep field: value}).

    A ``field="*"`` axis resolves to a dict of sweep-field overrides (or a
    callable from the point's built config to one — see `Axis`); its
    entries merge into the point's override dict like so many single-field
    axes.
    """
    dyn_axes = [ax for ax in plan.axes if ax.is_dynamic()]
    for ax in dyn_axes:
        if ax.target != "*" and ax.target not in _DYNAMIC_FIELDS:
            raise ValueError(f"axis {ax.name!r} is dynamic but targets "
                             f"unknown sweep field {ax.target!r}")
    overrides = []
    for pt, cfg in zip(points, cfgs):
        ov = {}
        for ax in dyn_axes:
            v = pt[ax.name]
            r = ax.resolve(v) if ax.resolve is not None else v
            if ax.target != "*":
                ov[ax.target] = r
                continue
            if callable(r):
                r = r(cfg)
            if not isinstance(r, dict):
                raise ValueError(
                    f"axis {ax.name!r} targets field='*' so each label "
                    f"must resolve to a dict of sweep-field overrides "
                    f"(or a callable(cfg) -> dict); "
                    f"label {pt[ax.name]!r} gave {type(r).__name__}")
            for fname, val in r.items():
                if fname not in _DYNAMIC_FIELDS:
                    raise ValueError(
                        f"axis {ax.name!r} (field='*') override names "
                        f"unknown sweep field {fname!r}")
                ov[fname] = val
        overrides.append(ov)
    return overrides


def resolve_plan(plan: Plan, *, pad_jobs: bool = True,
                 telemetry: Optional[TelemetrySpec] = None
                 ) -> tuple[list[dict], list[SimConfig], list[dict],
                            list[_Group]]:
    """The static partitioning stage of `run_plan`, without executing.

    Returns ``(points, cfgs, overrides, groups)``: the plan's label dicts,
    each point's built config (``telemetry`` stamped on if given), its
    resolved dynamic overrides, and the predicted compile groups (each
    group's ``idxs`` index into ``points``/``cfgs``).  This is exactly the
    grouping a cache-less `run_plan` would execute.
    """
    points = plan.points()
    cfgs = _stamp_telemetry([plan.build(dict(pt)) for pt in points],
                            telemetry)
    overrides = _resolve_overrides(plan, points, cfgs)
    groups = _compile_groups(cfgs, pad_jobs)
    return points, cfgs, overrides, groups


def group_sweep(cfgs: list[SimConfig], overrides: list[dict],
                group: _Group, device=None) -> SweepParams:
    """One compile group's batched SweepParams, exactly as `run_plan` would
    stack it (point params resolved on the group fabric, K = len(idxs)),
    on the card unless ``device="cpu"``."""
    per_point = [_point_params(cfgs[i], overrides[i], group)
                 for i in group.idxs]
    return _stack_params(per_point, device_mod.resolve(device))


def _load_kernels(cfg: SimConfig, sweep: SweepParams) -> float:
    """Seconds spent building or loading the kernel library the group's
    run will launch (0 on the CPU and once loaded): the chunk kernel's, or
    the per-tick CC kernel's for a configuration the chunk kernel does not
    take."""
    if sweep.slope.device.type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    if kernel_ops.chunk_fallback_reason(cfg, sweep) is None:
        nc.LIBRARY.load()
    elif kernel_ops.fallback_reason(cfg.protocol,
                                    sweep.static_job_factors) is None:
        ms.LIBRARY.load()
    return time.perf_counter() - t0


def _run_group(cfg: SimConfig, sweep: SweepParams, prof: GroupProfile,
               profile: bool):
    """The group's `simulate_sweep`, timed on the host clock around a
    synchronized run; its outputs moved to the host."""
    dev = sweep.slope.device
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    prof.compile_s = _load_kernels(cfg, sweep)
    if on_card:
        torch.cuda.synchronize(dev)
        if profile:
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t1 = time.perf_counter()
    with counters.watch() as w:
        raw = simulate_sweep(cfg, sweep, device=dev)
        if on_card:
            torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    prof.trace_s = 0.0
    prof.execute_s = t2 - t1
    prof.wall_s = t2 - t0
    prof.traced = w.traces > 0
    if on_card and profile:
        prof.device_bytes = int(torch.cuda.max_memory_allocated(dev) - base)
    if profile:
        from repro_torch.analysis import budget

        prof.cost_envelope = budget.group_envelope(cfg, sweep)
    # every leaf postprocess reads, on the host in one copy each
    return tree_map(lambda x: x.cpu(), raw._replace(final_state=None))


def run_plan(plan: Plan, *, device=None, shard="auto", pad_jobs: bool = True,
             cache_dir: Optional[str] = None,
             telemetry: Optional[TelemetrySpec] = None,
             profile: bool = False, keep_going: bool = False) -> PlanResult:
    """Execute a plan: one `simulate_sweep` per compile group, on the card
    unless ``device="cpu"``.

    shard:     "auto" | True | False — accepted as in the reference; the
               port runs each group on one card (see `_shard_sweep`).
    pad_jobs:  merge workload-size variants into one padded + masked group
               where possible (disable to force exact grouping).
    cache_dir: if given, a directory of per-point result pickles keyed by a
               content hash of (schema, point config, resolved overrides).
               Points already present are served from disk and *excluded*
               from group formation; fresh points are written back after
               postprocessing.  Interrupted plans resume where they
               stopped, and grown plans only simulate the new cells;
               `prune_cache` evicts entries of other schemas.
    telemetry: arm the probes and detectors (`netsim.telemetry`) on every
               point: the spec is stamped on each built config before
               grouping and before the cache keys, so it joins both, and
               each result carries a `.telemetry`
               (`telemetry.TelemetryResult`).
    profile:   also record each group's device-memory peak
               (`GroupProfile.device_bytes`) and launch envelope
               (`GroupProfile.cost_envelope`); the time split is recorded
               always, since it costs nothing here.
    keep_going: isolate per-group failures — a group that raises is
               recorded on `PlanResult.group_errors` (its members' result
               slots stay None) and the remaining groups still run and
               cache.  The default (False) re-raises at the failing group.
    """
    dev = device_mod.resolve(device)
    points = plan.points()
    cfgs = _stamp_telemetry([plan.build(dict(pt)) for pt in points],
                            telemetry)
    overrides = _resolve_overrides(plan, points, cfgs)

    results: list[Optional[metrics.SimResult]] = [None] * len(points)
    keys: list[Optional[str]] = [None] * len(points)
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        for i in range(len(points)):
            keys[i] = _point_cache_key(cfgs[i], overrides[i])
            results[i] = _cache_load(cache_dir, keys[i])
    n_cache_hits = sum(r is not None for r in results)
    todo = [i for i in range(len(points)) if results[i] is None]

    groups = _compile_groups([cfgs[i] for i in todo], pad_jobs)
    plan_profile = PlanProfile()
    group_errors: list[GroupError] = []
    with counters.watch(reset_warnings=True) as plan_watch:
        for gi, group in enumerate(groups):
            idxs = [todo[j] for j in group.idxs]  # group indexes todo subset
            try:
                per_point = [_point_params(cfgs[i], overrides[i], group)
                             for i in idxs]
                sweep = _stack_params(per_point, dev)
                k = len(idxs)
                sweep, _ = _shard_sweep(sweep, k, shard)
                prof = GroupProfile(n_points=k, n_jobs=group.cfg.jobs.n_jobs,
                                    n_flows=group.cfg.topo.n_flows,
                                    n_ticks=group.cfg.n_ticks,
                                    wall_s=0.0, traced=False,
                                    signature=_group_signature(group))
                raw = _run_group(group.cfg, sweep, prof, profile)
                plan_profile.groups.append(prof)
                for slot, i in enumerate(idxs):
                    point = SweepPoint(axes=dict(points[i]),
                                       params=per_point[slot],
                                       n_jobs=cfgs[i].jobs.n_jobs)
                    results[i] = metrics.postprocess(
                        cfgs[i], point_of(raw, slot), point=point,
                        n_jobs=point.n_jobs)
                    if cache_dir is not None:
                        _cache_save(cache_dir, keys[i], results[i])
            except Exception as exc:
                if not keep_going:
                    raise
                group_errors.append(GroupError(
                    group_index=gi,
                    signature=_group_signature(group),
                    point_labels=[SweepPoint(axes=dict(points[i])).label()
                                  for i in idxs],
                    error=f"{type(exc).__name__}: {exc}"))
    return PlanResult(plan=plan, results=results,
                      n_compile_groups=len(groups),
                      n_kernel_fallbacks=plan_watch.fallbacks,
                      n_cache_hits=n_cache_hits,
                      profile=plan_profile,
                      group_errors=group_errors,
                      n_kernel_launches=plan_watch.launches)
