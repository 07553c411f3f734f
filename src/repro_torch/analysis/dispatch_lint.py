"""Dispatch lint: prove, per group and without running it, the route the
port's wrappers will take on the card.

This replaces the JAX package's IR lint (``repro/analysis/jaxpr_lint.py``),
which walked the traced sweep program for the Pallas call, float64 values
and host callbacks.  The port traces nothing: whether a run goes through
the chunk kernel is decided once per run by `kernels.ops.netsim_chunk`, so
this layer asks the same functions that decision asks, in the same order
(`ops.chunk_fallback_reason`: `ops.fallback_reason`,
`ops.custom_probe_reason`, `netsim_chunk.budget_reason`), and never
re-states their logic:

* ``dispatch/kernel-fallback``: the card would take the counted per-tick
  path, with the reason, and which of its two routes: the CUDA graph of
  a chunk (`netsim.tick_graph`), or the eager loop where
  `tick_graph.eager_reason` keeps it (a user's Python callable in the
  tick), with that reason;
* ``dispatch/f64-operand``: a float64 tensor among the group's sweep
  leaves or its initial state (the counterpart of ``ir/f64-promotion``).

That the route proven here is the route taken is the runner's
accounting: on the card each group expected on the chunk kernel must
launch it once a chunk with no fallback (``dispatch/kernel-missing``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.analysis.findings import Finding, make_finding

__all__ = ["kernel_expectation", "per_tick_route", "float64_leaves",
           "initial_state", "lint_dispatch"]


def kernel_expectation(cfg, sweep) -> Union[str, tuple[str, str]]:
    """What the card runs for (cfg, sweep): ``"chunk"`` (the chunk kernel)
    or ``("per-tick", reason)`` (the counted per-tick path)."""
    from repro_torch.kernels import ops

    reason = ops.chunk_fallback_reason(cfg, sweep)
    return "chunk" if reason is None else ("per-tick", reason)


def per_tick_route(cfg) -> Union[str, tuple[str, str]]:
    """How the card runs a per-tick group: ``"graphed"`` (one CUDA graph
    replay a chunk) or ``("eager", reason)`` (op by op, counted in
    `tick_graph.EAGER_COUNT`)."""
    from repro_torch.netsim import tick_graph

    reason = tick_graph.eager_reason(cfg)
    return "graphed" if reason is None else ("eager", reason)


def _tensor_leaves(tree, path: str):
    """(path, tensor) of every tensor in a tree of NamedTuples, dicts and
    Nones (numpy leaves, the host-side key, are not operands)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _tensor_leaves(getattr(tree, name), f"{path}.{name}")


def float64_leaves(**trees) -> list[str]:
    """The paths of every float64 tensor in the named trees."""
    return [p for name, tree in trees.items()
            for p, t in _tensor_leaves(tree, name)
            if t.dtype == torch.float64]


def initial_state(cfg, sweep):
    """A group's run-start state as `engine.run_ticks` builds it, on the
    CPU: (statics, workload view, EngineState)."""
    from repro_torch.netsim import engine

    sweep = engine.SweepParams(*[None if v is None else v.cpu()
                                 for v in sweep])
    statics = engine._build_statics(cfg, torch.device("cpu"))
    st = engine._init_state(cfg, statics, sweep)
    wl = engine._workload_view(cfg, statics, sweep)
    return statics, wl, st


def lint_dispatch(cfg, sweep, *, label: str, state=None
                  ) -> tuple[list[Finding], dict]:
    """Lint one group's dispatch.  ``state`` is its initial EngineState
    (built here on the CPU when None).

    Returns (findings, facts); facts = {"expectation": "chunk" |
    "per-tick", "reason": str or None, "per_tick_route": None | "graphed"
    | "eager", "eager_reason": str or None, "f64_operands": int}.
    """
    findings: list[Finding] = []
    reason = route = eager_reason = None
    exp = kernel_expectation(cfg, sweep)
    if exp == "chunk":
        expectation = "chunk"
    else:
        expectation, reason = exp
        route = per_tick_route(cfg)
        if route == "graphed":
            how = "graphed (one CUDA graph replay a chunk)"
        else:
            route, eager_reason = route
            how = f"eager, op by op ({eager_reason})"
        findings.append(make_finding(
            "dispatch/kernel-fallback", label,
            f"the card runs this group on the counted per-tick path, "
            f"{how}: {reason}"))
    if state is None:
        state = initial_state(cfg, sweep)[2]
    f64 = float64_leaves(sweep=sweep, state=state)
    for path in f64:
        findings.append(make_finding(
            "dispatch/f64-operand", label,
            f"{path} is float64 (the pipeline is pinned float32)"))
    return findings, {"expectation": expectation, "reason": reason,
                      "per_tick_route": route, "eager_reason": eager_reason,
                      "f64_operands": len(f64)}
