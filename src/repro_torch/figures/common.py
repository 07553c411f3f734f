"""Shared helpers for the paper-figure suites, on the port.

The counterpart of ``benchmarks/common.py``.  Every suite declares a
`netsim.Plan` (named axes over a config builder) and `run_plan` partitions
it into compile groups, one `simulate_sweep` each: on the card one
`ChunkRun` of the chunk kernel, on the CPU the per-tick path.  Suites
report their simulated ticks from `PlanResult.n_ticks`.

Each entry point takes ``device=None``, the card, unless the caller asks
for ``"cpu"``; it is handed to `netsim.run_plan`.

Workload scaling as in the reference: the suites run the testbed's phase
ratios at ``WORK_SCALE`` of their length (0.25, or 1.0 under
``REPRO_FULL=1``); ``REPRO_SMOKE=1`` cuts the simulated time to 1.5 s and
the seeds to one.  The constants are read from the environment when this
module is imported, as the reference reads them; `at_depth` sets them for
a block (the plan registry and ``chip_smoke.py`` build and run the suites'
plans at a depth of their own).

    REPRO_SMOKE=1 PYTHONPATH=src python -m repro_torch.figures
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

from repro_torch import netsim, workload
from repro_torch.core import Algo, CCParams, MLTCPConfig, Variant


def depth(full=None, smoke=None) -> dict:
    """The depth constants of ``benchmarks/common.py`` for the flags
    ``full`` and ``smoke`` (each read from ``REPRO_FULL`` / ``REPRO_SMOKE``
    now when None), by this module's constant names."""
    if full is None:
        full = bool(int(os.environ.get("REPRO_FULL", "0")))
    if smoke is None:
        smoke = bool(int(os.environ.get("REPRO_SMOKE", "0")))
    return dict(FULL=full, SMOKE=smoke, WORK_SCALE=1.0 if full else 0.25,
                SIM_TIME=20.0 if full else (1.5 if smoke else 4.0),
                # the seed grid for error bars: a free sweep axis
                SEEDS=(1, 2, 3) if full else ((1,) if smoke else (1, 2)))


_ENV_DEPTH = depth()
FULL = _ENV_DEPTH["FULL"]
SMOKE = _ENV_DEPTH["SMOKE"]            # CI regression smoke
WORK_SCALE = _ENV_DEPTH["WORK_SCALE"]
SIM_TIME = _ENV_DEPTH["SIM_TIME"]
DT = 2e-5
SEEDS = _ENV_DEPTH["SEEDS"]


@contextlib.contextmanager
def at_depth(**constants):
    """For the block, this module's depth constants (``FULL``, ``SMOKE``,
    ``WORK_SCALE``, ``SIM_TIME``, ``SEEDS``) take the values given, e.g.
    ``at_depth(**depth(smoke=True))``; a plan built and run inside the
    block reads them.  The churn suite's own ``SIM_TIME`` (18 s times the
    workload scale) is set where it is imported, from ``WORK_SCALE``."""
    unknown = set(constants) - set(_ENV_DEPTH)
    if unknown:
        raise KeyError(f"not a depth constant: {sorted(unknown)}")
    saved = {k: globals()[k] for k in constants}
    globals().update(constants)
    try:
        yield
    finally:
        globals().update(saved)


# paper §4.1 defaults per scheme
PARAMS = {
    ("reno", "WI"): (1.75, 0.25),
    ("reno", "MD"): (1.0, 1.0),
    ("cubic", "WI"): (1.0, 0.5),
    ("cubic", "MD"): (0.8, 0.8),
    ("dcqcn", "WI"): (1.067, 0.267),
    ("dcqcn", "MD"): (1.067, 0.267),
}
ALGOS = {"reno": Algo.RENO, "cubic": Algo.CUBIC, "dcqcn": Algo.DCQCN}

# ECN thresholds for the RoCE fabric; RED drop thresholds for TCP
RED_BY_ALGO = {
    "reno": dict(red_qmin=150e3, red_qmax=1.5e6, red_pmax=0.12),
    "cubic": dict(red_qmin=150e3, red_qmax=1.5e6, red_pmax=0.12),
    "dcqcn": dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2),
}


def protocol(algo: str, variant: str = "WI", slope=None, intercept=None,
             f_spec: str = "linear", **cfg_kw) -> MLTCPConfig:
    var = {"OFF": Variant.OFF, "WI": Variant.WI, "MD": Variant.MD,
           "BOTH": Variant.BOTH}[variant]
    s_def, i_def = PARAMS.get((algo, "WI" if variant == "OFF" else variant),
                              (1.75, 0.25))
    return MLTCPConfig(
        cc=CCParams(algo=int(ALGOS[algo]), variant=int(var), tick_dt=DT,
                    rtt=100e-6),
        slope=s_def if slope is None else slope,
        intercept=i_def if intercept is None else intercept,
        f_spec=f_spec,
        **cfg_kw)


def build_cfg(topo, profiles, proto, *, sim_time=None, seed=1,
              straggle_prob=None, start_offset=None, cassini=None,
              static_job_factors=None, scale=None, **kw) -> netsim.SimConfig:
    scale = WORK_SCALE if scale is None else scale
    profiles = [p.scaled(scale) for p in profiles]
    jobs = workload.jobspec_from_profiles(profiles,
                                          straggle_prob=straggle_prob,
                                          start_offset=start_offset)
    algo = {int(v): k for k, v in ALGOS.items()}[proto.cc.algo]
    return netsim.SimConfig(
        topo=topo, jobs=jobs, protocol=proto,
        sim_time=SIM_TIME if sim_time is None else sim_time, dt=DT,
        seed=seed, cassini=cassini, static_job_factors=static_job_factors,
        **{**RED_BY_ALGO[algo], **kw})


def plan(build, *, name: str = "", where=None, **axes) -> netsim.Plan:
    """Declare an experiment plan from keyword axes.

    Each ``axes`` value is either a value sequence or a `netsim.Axis`
    (renamed to its keyword); ``build`` maps a point's label dict to its
    `SimConfig`.  Run with `run_plan`.
    """
    resolved = []
    for key, v in axes.items():
        if isinstance(v, netsim.Axis):
            resolved.append(dataclasses.replace(v, name=key))
        else:
            resolved.append(netsim.Axis(key, tuple(v)))
    return netsim.Plan(name=name, axes=tuple(resolved), build=build,
                       where=where)


# Per-suite health, summed over every plan a suite runs; `timed` resets it
# per suite and attaches the totals to the BenchResult, which the harness
# prints and merges as the suite's ``_health``.  ``n_kernel_fallbacks``
# counts both of the port's fallbacks (`counters.fallbacks`: CC ticks
# through `core.cc_tick` and runs on the card sent down the per-tick
# path).  The last keys are the static verifier's verdict: groups the plan
# lint predicted before the run, plans whose run made another number of
# groups, and plan-lint findings above info.
_PLAN_HEALTH = {"n_kernel_fallbacks": 0, "n_cache_hits": 0,
                "n_compile_groups": 0, "n_groups_predicted": 0,
                "n_group_mispredicts": 0, "n_plan_findings": 0,
                "n_group_errors": 0, "n_budget_mismatches": 0}


def reset_plan_health() -> None:
    for k in _PLAN_HEALTH:
        _PLAN_HEALTH[k] = 0


def plan_health() -> dict:
    return dict(_PLAN_HEALTH)


def _budget_mismatches(pr: netsim.PlanResult, device) -> int:
    """Every profiled group whose launch envelope
    (`GroupProfile.cost_envelope`, filled under ``profile=True``) matches
    no recorded budget of the same signature in ``analysis/budgets.json``.
    Groups without an envelope, without a baseline of their signature, or
    under another environment (depth, torch, device) are not counted."""
    measured = [g for g in pr.profile.groups
                if g.cost_envelope is not None and g.signature]
    if not measured:
        return 0
    from repro_torch import device as device_mod
    from repro_torch.analysis.budget import BudgetBook

    book = BudgetBook(device=device_mod.resolve(device).type)
    return sum(1 for g in measured
               if book.matches_any(g.signature, g.cost_envelope) is False)


def run_plan(p: netsim.Plan, *, device=None, **kw) -> netsim.PlanResult:
    """Execute a plan on ``device`` (the card unless ``"cpu"``), adding its
    health to the suite's.

    The plan lint runs first: its predicted groups and its findings above
    info land in the health block, and a run whose groups differ from the
    prediction counts as a mispredict.
    """
    from repro_torch.analysis import plan_lint

    findings, facts = plan_lint.lint_plan(
        p, label=p.name or "plan", pad_jobs=kw.get("pad_jobs", True),
        telemetry=kw.get("telemetry"))
    predicted = facts["groups"]

    pr = netsim.run_plan(p, device=device, **kw)
    _PLAN_HEALTH["n_budget_mismatches"] += _budget_mismatches(pr, device)
    _PLAN_HEALTH["n_kernel_fallbacks"] += pr.n_kernel_fallbacks
    _PLAN_HEALTH["n_cache_hits"] += pr.n_cache_hits
    _PLAN_HEALTH["n_compile_groups"] += pr.n_compile_groups
    # keep_going=True salvage: failed groups land here instead of aborting
    # the suite; a nonzero count in _health flags the partial run
    _PLAN_HEALTH["n_group_errors"] += len(pr.group_errors)
    _PLAN_HEALTH["n_groups_predicted"] += predicted
    _PLAN_HEALTH["n_group_mispredicts"] += int(
        predicted != pr.n_compile_groups)
    _PLAN_HEALTH["n_plan_findings"] += sum(
        1 for f in findings if f.effective_severity != "info")
    return pr


def seed_axis(seeds=None) -> netsim.Axis:
    """The shared multi-seed error-bar axis (a free sweep lane; every suite
    appends it to its plan)."""
    return netsim.Axis("seed", tuple(SEEDS if seeds is None else seeds))


def sim(topo, profiles, proto, device=None, **kw) -> netsim.SimResult:
    """One simulation as a single-point plan (kept for one-off runs)."""
    pr = run_plan(plan(lambda pt: build_cfg(topo, profiles, proto, **kw),
                       name="single"), device=device)
    return pr.results[0]


# The reference's results/benchmarks.json is its own; the port's suites
# merge into a file of their own beside it.
RESULTS_PATH = os.path.join("results", "figures_torch.json")


def merge_results(new: dict, path: str = RESULTS_PATH) -> dict:
    """Merge suite results into the results JSON, keyed by suite name.

    Load if it exists, update, dump: a partial run (one suite, a new suite)
    updates only its own keys and keeps what the other suites recorded on
    earlier runs.  The dump goes through a temporary file and `os.replace`,
    so a crash mid-write never leaves a truncated file; an unreadable file
    is rewritten from this run.  Returns the merged dict.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            data = {}          # corrupt/unreadable: rewrite from this run
    data.update(new)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1)
    os.replace(tmp, path)
    return data


@dataclasses.dataclass
class BenchResult:
    name: str
    wall_s: float
    n_ticks: int
    derived: dict
    # health over every plan the suite ran (plan_health())
    health: dict = dataclasses.field(default_factory=dict)

    def csv_line(self) -> str:
        us = 1e6 * self.wall_s / max(self.n_ticks, 1)
        key, val = next(iter(self.derived.items()))
        line = f"{self.name},{us:.3f},{key}={val}"
        if self.health:
            line += (f",fallbacks={self.health.get('n_kernel_fallbacks', 0)}"
                     f",cache_hits={self.health.get('n_cache_hits', 0)}")
        return line


def timed(name: str, fn) -> BenchResult:
    reset_plan_health()
    t0 = time.time()
    derived, n_ticks = fn()
    return BenchResult(name, time.time() - t0, n_ticks, derived,
                       health=plan_health())


def gpt2(n: int = 1) -> list[workload.CommProfile]:
    return [workload.profile_for("gpt2") for _ in range(n)]
