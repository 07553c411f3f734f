"""Metrics over raw simulation outputs — the paper's reported quantities.

* per-job training-iteration times (avg / p99 / CDF)  — Figs 7c, 8c, 9c, 11
* dropped / ECN-marked packets per second             — Figs 7b, 8b, 9b
* link-utilization traces                             — Figs 7a, 8a, 9a, 14
* interleave score: pairwise Jaccard overlap of comm phases on shared links
* speedups vs a baseline run                          — Figs 10, 12, 13

Everything here is numpy on the host: a raw output's leaves may be torch
tensors (on any device) or numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.netsim.engine import (RawSimOutput, SimConfig, SweepPoint,
                                       point_of)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class SimResult:
    """Post-processed, numpy-side view of one simulation; ``point`` names
    the sweep grid point it belongs to, when it came from a sweep."""

    cfg: SimConfig
    iter_times: list[np.ndarray]      # per job, valid entries only
    drops_per_s: float
    marks_per_s: float
    trace_t: np.ndarray               # [C]
    trace_util: np.ndarray            # [C, M]
    trace_incomm: np.ndarray          # [C, J]
    trace_drops: np.ndarray           # [C]
    trace_jobtput: np.ndarray         # [C, J] delivered bytes/s per job
    point: Optional[SweepPoint] = None

    @property
    def n_jobs(self) -> int:
        return len(self.iter_times)

    def avg_iter(self, job: int, warmup: int = 5) -> float:
        x = self.iter_times[job][warmup:]
        return float(np.mean(x)) if x.size else float("nan")

    def p99_iter(self, job: int, warmup: int = 5) -> float:
        x = self.iter_times[job][warmup:]
        return float(np.percentile(x, 99)) if x.size else float("nan")

    def all_iters(self, warmup: int = 5) -> np.ndarray:
        xs = [x[warmup:] for x in self.iter_times if x.size > warmup]
        return np.concatenate(xs) if xs else np.asarray([])


def postprocess(cfg: SimConfig, raw: RawSimOutput,
                point: Optional[SweepPoint] = None,
                n_jobs: Optional[int] = None) -> SimResult:
    """Numpy-side view of one raw simulation (no K axis); ``n_jobs`` trims
    the job-indexed outputs to the active jobs of a padded fabric."""
    it = _np(raw.iter_times)
    counts = _np(raw.iter_counts)
    n = it.shape[0] if n_jobs is None else min(n_jobs, it.shape[0])
    per_job = [it[j, : int(min(counts[j], it.shape[1]))] for j in range(n)]
    per_job = [x[~np.isnan(x)] for x in per_job]
    trace_t = _np(raw.trace_t)
    sim_t = float(trace_t[-1]) if trace_t.size else cfg.sim_time
    return SimResult(
        cfg=cfg,
        iter_times=per_job,
        drops_per_s=float(_np(raw.trace_drops).sum() / max(sim_t, 1e-9)),
        marks_per_s=float(_np(raw.trace_marks).sum() / max(sim_t, 1e-9)),
        trace_t=trace_t,
        trace_util=_np(raw.trace_util),
        trace_incomm=_np(raw.trace_incomm)[:, :n],
        trace_drops=_np(raw.trace_drops),
        trace_jobtput=_np(raw.trace_jobtput)[:, :n],
        point=point,
    )


def postprocess_sweep(cfg: SimConfig, raw: RawSimOutput,
                      points: Optional[list[SweepPoint]] = None
                      ) -> list[SimResult]:
    """One SimResult per grid point of a `simulate_sweep` output, in sweep
    order; ``points`` (from `grid_sweep`) labels each result."""
    k = int(_np(raw.iter_counts).shape[0])
    if points is not None and len(points) != k:
        raise ValueError(f"{len(points)} points for a K={k} sweep")
    return [postprocess(cfg, point_of(raw, i),
                        point=None if points is None else points[i],
                        n_jobs=None if points is None else points[i].n_jobs)
            for i in range(k)]


def iteration_times(cfg: SimConfig, raw: RawSimOutput) -> list[np.ndarray]:
    return postprocess(cfg, raw).iter_times


def interleave_score(res: SimResult, job_a: int, job_b: int,
                     tail_frac: float = 0.5) -> float:
    """Jaccard overlap of two jobs' comm phases over the trace tail.

    0.0 = perfectly interleaved, 1.0 = fully synchronized.
    """
    ic = res.trace_incomm
    start = int(ic.shape[0] * (1.0 - tail_frac))
    a = ic[start:, job_a].astype(bool)
    b = ic[start:, job_b].astype(bool)
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(a, b).sum() / union)


def mean_pairwise_interleave(res: SimResult, tail_frac: float = 0.5) -> float:
    j = res.trace_incomm.shape[1]
    scores = [interleave_score(res, a, b, tail_frac)
              for a in range(j) for b in range(a + 1, j)]
    return float(np.mean(scores)) if scores else 0.0


def speedup_stats(base: SimResult, test: SimResult,
                  warmup: int = 5) -> dict[str, float]:
    """Training-iteration-time speedups of ``test`` over ``base``: ratio of
    avg and p99 iteration times across all jobs."""
    b, t = base.all_iters(warmup), test.all_iters(warmup)
    return {
        "avg_speedup": float(np.mean(b) / np.mean(t)),
        "p99_speedup": float(np.percentile(b, 99) / np.percentile(t, 99)),
        "base_avg": float(np.mean(b)), "test_avg": float(np.mean(t)),
        "base_p99": float(np.percentile(b, 99)),
        "test_p99": float(np.percentile(t, 99)),
    }


def sweep_speedup_stats(bases: list[SimResult], tests: list[SimResult],
                        warmup: int = 5) -> dict[str, float]:
    """Seed-paired speedups over a sweep: mean and (population) std across
    the points — the paper-figure error bars."""
    if len(bases) != len(tests):
        raise ValueError(f"sweep lengths differ: {len(bases)} vs {len(tests)}")
    per = [speedup_stats(b, t, warmup) for b, t in zip(bases, tests)]
    avg = np.asarray([p["avg_speedup"] for p in per])
    p99 = np.asarray([p["p99_speedup"] for p in per])
    return {
        "avg_speedup": float(avg.mean()), "avg_speedup_std": float(avg.std()),
        "p99_speedup": float(p99.mean()), "p99_speedup_std": float(p99.std()),
        "n_points": len(per),
    }
