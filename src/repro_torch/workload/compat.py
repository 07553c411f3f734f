"""Job compatibility (paper §2.2 Challenge 1, §4.6; concept from [66, 67]).

Two jobs sharing a link are *compatible* when the comm phase of one fits in
the compute phase of the other.  The score below follows Cassini's geometric
definition: place each job's comm window on the circle of its period, sweep
relative offsets, and measure the best-case non-overlap of comm time.

score = 1  -> a relative shift exists where comm phases never collide;
score -> 0 -> comm phases must overlap almost entirely no matter the shift.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.workload.comm_model import CommProfile, GBPS


def _comm_windows(p: CommProfile, link_rate: float) -> tuple[np.ndarray, float]:
    """[(start, end)] of comm windows within one iteration, plus the period."""
    t = 0.0
    wins = []
    for c, b in zip(p.compute_s, p.comm_bytes):
        t += c
        dur = b / link_rate
        wins.append((t, t + dur))
        t += dur
    return np.asarray(wins), t


def _overlap_on_circle(wa: np.ndarray, per_a: float, wb: np.ndarray,
                       per_b: float, offset: float, horizon: float) -> float:
    """Total seconds both jobs communicate simultaneously in [0, horizon)."""
    grid = np.linspace(0.0, horizon, 4096, endpoint=False)

    def busy(wins, per, off):
        ph = np.mod(grid - off, per)
        out = np.zeros_like(grid, dtype=bool)
        for (s, e) in wins:
            out |= (ph >= s) & (ph < e)
        return out

    a = busy(wa, per_a, 0.0)
    b = busy(wb, per_b, offset)
    both = np.logical_and(a, b).mean() * horizon
    tot_b = b.mean() * horizon
    return both, tot_b


def compatibility_score(a: CommProfile, b: CommProfile,
                        link_rate: float = 50 * GBPS,
                        n_offsets: int = 64) -> float:
    """max over relative offsets of (1 - overlapped comm fraction)."""
    wa, pa = _comm_windows(a, link_rate)
    wb, pb = _comm_windows(b, link_rate)
    horizon = max(pa, pb) * 4
    best = 0.0
    for off in np.linspace(0.0, pb, n_offsets, endpoint=False):
        both, tot_b = _overlap_on_circle(wa, pa, wb, pb, off, horizon)
        frac = 1.0 - (both / tot_b if tot_b > 0 else 0.0)
        best = max(best, frac)
    return float(best)


def best_offsets(profiles: list[CommProfile],
                 link_rate: float = 50 * GBPS,
                 n_offsets: int = 32) -> np.ndarray:
    """Brute-force joint offsets minimizing pairwise comm overlap (used by
    the Cassini baseline on a single shared link).  Job 0 is the reference.
    Exponential in job count; fine for the paper's 2-3-job experiments, and
    greedy beyond that."""
    j = len(profiles)
    wins = []
    pers = []
    for p in profiles:
        w, per = _comm_windows(p, link_rate)
        wins.append(w)
        pers.append(per)
    horizon = max(pers) * 4

    if j <= 3:
        cands = [np.linspace(0.0, pers[i], n_offsets, endpoint=False)
                 for i in range(j)]
        best, best_off = None, np.zeros((j,))
        for combo in itertools.product(*[cands[i] for i in range(1, j)]):
            offs = np.asarray((0.0,) + combo)
            tot = 0.0
            for x in range(j):
                for y in range(x + 1, j):
                    both, _ = _overlap_on_circle(
                        wins[x], pers[x], wins[y], pers[y],
                        offs[y] - offs[x], horizon)
                    tot += both
            if best is None or tot < best:
                best, best_off = tot, offs
        return best_off

    # greedy: place jobs one at a time at the offset minimizing added overlap
    offs = np.zeros((j,))
    for i in range(1, j):
        best, arg = None, 0.0
        for off in np.linspace(0.0, pers[i], n_offsets, endpoint=False):
            tot = 0.0
            for x in range(i):
                both, _ = _overlap_on_circle(wins[x], pers[x], wins[i],
                                             pers[i], off - offs[x], horizon)
                tot += both
            if best is None or tot < best:
                best, arg = tot, off
        offs[i] = arg
    return offs
