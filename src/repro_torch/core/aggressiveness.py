"""Bandwidth aggressiveness functions F(bytes_ratio) — paper §3.3, Figure 5.

MLTCP scales congestion-control aggressiveness by ``F(bytes_ratio)``.  The
paper's requirements for a valid F (§3.3): (i) a range large enough to
absorb network noise, (ii) dF/dx >= 0, (iii) all flows use the same F.

The default is the paper's linear function F(x) = S*x + I (Eq. 3); F1..F6
are the six functions of the §4.8 / Figure 15 ablation (F1..F4 increasing
interleave; F5, F6 decreasing fail).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

Tensor = torch.Tensor
AggressivenessFn = Callable[[Tensor], Tensor]


@dataclasses.dataclass(frozen=True)
class LinearF:
    """The paper's Eq. 3:  F(bytes_ratio) = S * bytes_ratio + I.

    ``slope``/``intercept`` are python floats or ``[K, 1]`` per-point
    columns (a sweep varies them without new code paths).
    """

    slope: object
    intercept: object

    def __call__(self, bytes_ratio: Tensor) -> Tensor:
        return self.slope * bytes_ratio + self.intercept


def linear(slope, intercept) -> LinearF:
    return LinearF(slope, intercept)


# ---------------------------------------------------------------------------
# The six ablation functions of §4.8 (all share range [0.25, 2] on x in [0,1]).
# ---------------------------------------------------------------------------

def _f1(x: Tensor) -> Tensor:  # linear increasing (the default shape)
    return 1.75 * x + 0.25


def _f2(x: Tensor) -> Tensor:  # convex increasing
    return 1.75 * (x * x) + 0.25


def _f3(x: Tensor) -> Tensor:  # inverse increasing
    return 1.0 / (-3.5 * x + 4.0)


def _f4(x: Tensor) -> Tensor:  # concave increasing
    return -1.75 * (x * x) + 3.5 * x + 0.25


def _f5(x: Tensor) -> Tensor:  # linear DECREASING (cancels SRPT; must fail)
    return -1.75 * x + 2.0


def _f6(x: Tensor) -> Tensor:  # concave DECREASING (must fail)
    return -1.75 * (x * x) + 2.0


def paper_functions() -> Dict[str, AggressivenessFn]:
    """F1..F6 from §4.8 / Figure 15."""
    return {"F1": _f1, "F2": _f2, "F3": _f3, "F4": _f4, "F5": _f5, "F6": _f6}


_REGISTRY: Dict[str, AggressivenessFn] = dict(paper_functions())


def make_fn(spec, slope=None, intercept=None) -> AggressivenessFn:
    """Resolve an aggressiveness function: a callable (as-is), one of
    "F1".."F6", or "linear" (requires slope/intercept)."""
    if callable(spec):
        return spec
    if spec == "linear":
        if slope is None or intercept is None:
            raise ValueError("linear F requires slope and intercept")
        return linear(slope, intercept)
    if spec in _REGISTRY:
        return _REGISTRY[spec]
    raise ValueError(f"unknown aggressiveness function {spec!r}")


def is_srpt_reinforcing(fn: AggressivenessFn, n: int = 256) -> bool:
    """Requirement (ii): non-negative derivative over [0, 1]."""
    xs = torch.linspace(0.0, 1.0, n, dtype=torch.float32)
    ys = fn(xs)
    return bool(torch.all(torch.diff(ys) >= -1e-7))
