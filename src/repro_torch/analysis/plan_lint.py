"""Plan lint: predict a plan's groups and explain every split.

Reuses `experiment.resolve_plan`, the *same* canonicalization and
bucketing `run_plan` executes, so the prediction is the execution minus
the run.  In the port a "compile group" is one `simulate_sweep`: on the
card one `kernels.netsim_chunk.ChunkRun`, one launch of the chunk kernel a
chunk for all of the group's points.  Nothing is compiled per group (the
kernels are built once per process), so an avoidable split costs a
separate run, its own host draws and its own launches every chunk, not a
compile.

For each pair of predicted groups the linter diffs their canonical static
configs field by field and emits:

* ``plan/group-split`` (info): the exact canonicalized field paths that
  differ, so no split is ever unexplained;
* ``plan/avoidable-split`` (warning): every differing field is a plain
  numeric value (not structural: not a shape, flag, enum or string), i.e.
  it could ride the batched sweep as a `SweepParams` leaf; the facts carry
  the wasted-run estimate (extra groups that would merge if those fields
  were swept dynamically).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis.findings import Finding, make_finding

__all__ = ["lint_plan", "predict_compile_groups", "STRUCTURAL_FIELDS"]

# Field basenames that legitimately change the run's structure (tensor
# shapes, the kernel's specialization, python-level branches in the
# engine).  Splits on anything *outside* this set are flagged avoidable.
STRUCTURAL_FIELDS = frozenset({
    # engine structure
    "sim_time", "dt", "n_chunks", "max_iters_recorded", "telemetry",
    "cubic_epoch_reset_on_comm_start", "seed",
    # protocol dispatch
    "algo", "variant", "f_spec", "favoritism", "aggregate_by_job",
    "ecn_mode", "rtt", "tick_dt", "mss",
    # workload / fabric shape
    "n_jobs", "n_flows", "n_phases", "sockets_per_job",
    # fault-injection structure (netsim.faults.FaultSpec: the event-table
    # row count and armed channels shape the run; schedule *values* ride
    # the sweep and never appear in canonical configs)
    "faults", "n_events", "churn", "link_flaps", "blackholes",
    "straggle_bursts",
})


def _leaf_diffs(a, b, path: str, out: list) -> None:
    if a is b:
        return
    if type(a) is not type(b):
        out.append((path, a, b))
        return
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            sub = f"{path}.{f.name}" if path else f.name
            _leaf_diffs(getattr(a, f.name), getattr(b, f.name), sub, out)
        return
    if isinstance(a, tuple) and hasattr(a, "_fields"):   # NamedTuple
        for fname in a._fields:
            sub = f"{path}.{fname}" if path else fname
            _leaf_diffs(getattr(a, fname), getattr(b, fname), sub, out)
        return
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            out.append((path + ".len", len(a), len(b)))
            return
        for i, (x, y) in enumerate(zip(a, b)):
            _leaf_diffs(x, y, f"{path}[{i}]", out)
        return
    if isinstance(a, np.ndarray):
        if a.shape != b.shape or a.dtype != b.dtype:
            out.append((path, f"{a.dtype}{list(a.shape)}",
                        f"{b.dtype}{list(b.shape)}"))
        elif not np.array_equal(a, b):
            out.append((path, "<array values>", "<array values>"))
        return
    if a != b:
        out.append((path, a, b))


def _short(v) -> str:
    s = repr(v)
    return s if len(s) <= 40 else s[:37] + "..."


def _basename(path: str) -> str:
    return path.split(".")[-1].split("[")[0]


def _is_avoidable(path: str, va, vb) -> bool:
    """A diff a SweepParams leaf could absorb: plain numeric value,
    non-structural name, identical shapes."""
    if _basename(path) in STRUCTURAL_FIELDS:
        return False
    for v in (va, vb):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return False
    return True


def predict_compile_groups(plan, *, pad_jobs: bool = True,
                           telemetry=None) -> int:
    """How many runs `run_plan` will make for this plan (no cache)."""
    from repro_torch.netsim import experiment

    _, _, _, groups = experiment.resolve_plan(
        plan, pad_jobs=pad_jobs, telemetry=telemetry)
    return len(groups)


def lint_plan(plan, *, label: str, pad_jobs: bool = True,
              telemetry=None) -> tuple[list[Finding], dict]:
    """Explain (and judge) a plan's group structure.

    Returns ``(findings, facts)``; facts hold the counts, ``splits`` (each
    split's location -> its differing field paths, in full) and
    ``_resolved``, the ``(points, cfgs, overrides, groups)`` the runner
    reuses without re-resolving the plan.
    """
    from repro_torch.netsim import experiment

    points, cfgs, overrides, groups = experiment.resolve_plan(
        plan, pad_jobs=pad_jobs, telemetry=telemetry)
    findings: list[Finding] = []
    splits: dict[str, list[str]] = {}

    # Pairwise split explainers.  G is small (a handful of groups per
    # figure suite); O(G^2) diffs of canonical configs cost nothing next
    # to one run.
    mergeable_with: dict[int, int] = {}      # union-find over groups

    def find(i: int) -> int:
        while mergeable_with.get(i, i) != i:
            i = mergeable_with[i]
        return i

    for gi in range(len(groups)):
        for gj in range(gi + 1, len(groups)):
            diffs: list = []
            _leaf_diffs(groups[gi].cfg, groups[gj].cfg, "", diffs)
            if not diffs:
                # same canonical cfg, split by factor presence or shape
                # merge heuristics: explain via the group flags
                diffs = [("static_job_factors.presence",
                          groups[gi].factors, groups[gj].factors)]
            where = f"{label}/group{gi}~group{gj}"
            splits[where] = [p for p, _, _ in diffs]
            detail = "; ".join(f"{p}: {_short(va)} != {_short(vb)}"
                               for p, va, vb in diffs[:6])
            if len(diffs) > 6:
                detail += f"; ... {len(diffs) - 6} more"
            findings.append(make_finding(
                "plan/group-split", where,
                f"{len(diffs)} canonical field(s) differ: {detail}"))
            if diffs and all(_is_avoidable(p, va, vb) for p, va, vb in diffs):
                findings.append(make_finding(
                    "plan/avoidable-split", where,
                    f"split only on value-like field(s) "
                    f"{sorted({_basename(p) for p, _, _ in diffs})}: these "
                    f"could be SweepParams leaves; merging would save one "
                    f"run and its launches"))
                ri, rj = find(gi), find(gj)
                if ri != rj:
                    mergeable_with[max(ri, rj)] = min(ri, rj)

    wasted = sum(1 for g in range(len(groups)) if find(g) != g)
    facts = {
        "points": len(points), "groups": len(groups),
        "wasted_runs_estimate": wasted, "splits": splits,
        "_resolved": (points, cfgs, overrides, groups),
    }
    return findings, facts
