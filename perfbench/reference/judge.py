"""The comparison that decides ``correct`` for the simulator's cells.

The program's answers for the judged points of one plan (each point's
`SimResult` and the raw outputs `run_plan` post-processed) are held
against the plain reference's (`reference.fluid`) for the same points,
computed from the configuration and the seeds alone.  The comparison is
exact: the reference repeats the simulator's float32 arithmetic operation
for operation, so a correct program gives the same bits.  Where a point's
loss or CNP draw falls within a few ulps of its probability, two correct
``expm1`` may decide that event either way; that point is compared up to
the chunk that holds its first such tick (`reference.fluid`'s
``first_ambiguous``), and its iterations up to the last one ending a
millisecond before that tick.  What is compared of a point:

* each active job's iteration times (all of them, in order);
* the seven chunk traces (utilization, drops, marks, comm-phase flags,
  time, per-job throughput, per-job bytes_ratio), chunk by chunk;
* the result's drops and marks per second, where the point has no
  ambiguous draw;
* and that the result's own copies of five traces equal the raw ones.

The number compared, ``diverged_pct``, is the share of the judged points
that differ anywhere in what is compared, in percent; its limit is in the
configuration file under ``limits``.  ``coverage_pct`` (the share of the
judged point-ticks before their point's first ambiguous draw) and, for a
point that differs, what differs first are reported beside it.
"""
from __future__ import annotations

import numpy as np

TRACES = ("trace_util", "trace_drops", "trace_marks", "trace_incomm",
          "trace_t", "trace_jobtput", "trace_ratio")
RESULT_TRACES = ("trace_t", "trace_util", "trace_incomm", "trace_drops",
                 "trace_jobtput")
NUMBERS = ("diverged_pct",)
# iterations ending this close before an ambiguous tick are not compared
MARGIN_S = 1e-3


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def program_view(result, raw, n_jobs: int) -> dict:
    """One point of the program as `reference.fluid.postprocess` lays out
    the reference's: the result's fields and the raw chunk traces."""
    out = dict(iter_times=[np.asarray(x) for x in result.iter_times],
               drops_per_s=result.drops_per_s,
               marks_per_s=result.marks_per_s)
    for name in TRACES:
        v = _np(getattr(raw, name))
        if name in ("trace_incomm", "trace_jobtput", "trace_ratio"):
            v = v[:, :n_jobs]
        out[name] = v
    out["result_traces"] = {n: np.asarray(getattr(result, n))
                            for n in RESULT_TRACES}
    return out


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def compare_point(prog: dict, ref: dict) -> dict:
    """Where one point differs (None: nowhere) and the share of its ticks
    that was compared."""
    n_ticks = ref["trace_t"].shape[0] * ref["ticks_per_chunk"]
    amb = min(ref["first_ambiguous"], n_ticks)
    whole = amb >= n_ticks
    chunks = amb // ref["ticks_per_chunk"]
    cut_s = amb * ref["dt"] - MARGIN_S
    diff = None
    for n in RESULT_TRACES:
        if not _same(prog["result_traces"][n], prog[n]):
            diff = f"the result's {n} is not the raw one"
    if len(prog["iter_times"]) != len(ref["iter_times"]):
        diff = diff or "active jobs"
    for j, (p, r) in enumerate(zip(prog["iter_times"], ref["iter_times"])):
        r = np.asarray(r)
        if not whole:
            r = r[:int(np.searchsorted(np.cumsum(r, dtype=np.float64),
                                       cut_s, side="right"))]
        if len(p) < len(r) or not _same(p[:len(r)], r) or (
                whole and len(p) != len(r)):
            diff = diff or f"iteration times of job {j}"
    for n in TRACES:
        p, r = np.asarray(prog[n]), np.asarray(ref[n])
        if p.shape != r.shape or not _same(p[:chunks], r[:chunks]):
            diff = diff or n
    if whole:
        for n in ("drops_per_s", "marks_per_s"):
            if prog[n] != ref[n]:
                diff = diff or n
    return dict(diff=diff, compared=amb / n_ticks)


def missing() -> dict:
    """A point the program gave no answer for."""
    return dict(diff="no result", compared=1.0)


def judge(per_point: list[dict], limits: dict) -> dict:
    """The plan's number beside its limit, what else was seen, and the
    verdict."""
    if not per_point:
        return dict(correct=False, numbers={}, info={},
                    reason="no point compared")
    nums = dict(diverged_pct=100.0 * sum(p["diff"] is not None
                                         for p in per_point)
                / len(per_point))
    compared = {n: dict(value=nums[n], limit=limits[n]) for n in NUMBERS}
    first = next((p["diff"] for p in per_point if p["diff"]), None)
    info = dict(points=len(per_point),
                coverage_pct=100.0 * float(np.mean(
                    [p["compared"] for p in per_point])),
                ambiguous_points=sum(p["compared"] < 1.0 for p in per_point),
                first_difference=first)
    ok = all(nums[n] <= limits[n] for n in NUMBERS)
    return dict(correct=ok, numbers=compared, info=info)
