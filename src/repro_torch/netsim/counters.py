"""One accessor over the port's runtime health counters.

The reference reads two process-global counters: sweep-program traces and
CC-tick fallbacks.  The port traces nothing; its counterpart of one trace
per compile group is one run of `engine.run_ticks` per `simulate_sweep`
call (``engine.RUN_COUNT``).  Its fallbacks are of two kinds, both counted
in `repro_torch.kernels.ops`: a CC tick routed through `core.cc_tick`
(``FALLBACK_COUNT``) and a run on the card sent down the per-tick path
(``CHUNK_FALLBACK_COUNT``).  The chunk kernel counts its own launches
(``netsim_chunk.LAUNCH_COUNT``).

    from repro_torch.netsim import counters

    with counters.watch() as w:
        run_plan(plan)
    assert w.traces == 2 and w.fallbacks == 0

``watch()`` snapshots the counters at entry; the handle's ``.traces`` /
``.fallbacks`` / ``.launches`` are live deltas (they keep counting after
the ``with`` block exits).  Reading never imports the kernels package: a
counter of a module that was never imported reads 0.
"""
from __future__ import annotations

import contextlib
import sys

__all__ = ["traces", "fallbacks", "launches", "reset_fallback_warnings",
           "watch", "CounterWatch"]


def traces() -> int:
    """Runs of `engine.run_ticks` this process (one per `simulate_sweep`
    call, so one per compile group of a plan): the port's counterpart of
    the reference's sweep-program traces."""
    from repro_torch.netsim import engine

    return engine.RUN_COUNT


def _counter(module: str, name: str) -> int:
    mod = sys.modules.get(module)
    return getattr(mod, name, 0) if mod is not None else 0


def fallbacks() -> int:
    """CC ticks routed through `core.cc_tick` plus runs on the card sent
    down the per-tick path (``ops.FALLBACK_COUNT`` +
    ``ops.CHUNK_FALLBACK_COUNT``)."""
    return (_counter("repro_torch.kernels.ops", "FALLBACK_COUNT")
            + _counter("repro_torch.kernels.ops", "CHUNK_FALLBACK_COUNT"))


def launches() -> int:
    """Launches of the chunk kernel (``netsim_chunk.LAUNCH_COUNT``)."""
    return _counter("repro_torch.kernels.netsim_chunk", "LAUNCH_COUNT")


def reset_fallback_warnings() -> None:
    """Re-arm ops.py's once-per-reason fallback warnings (no-op when the
    kernels were never imported).  `run_plan` calls this per plan so each
    plan warns at most once per fallback reason."""
    mod = sys.modules.get("repro_torch.kernels.ops")
    if mod is not None:
        mod.reset_fallback_warnings()


class CounterWatch:
    """Live deltas of the counters since construction."""

    def __init__(self) -> None:
        self._traces0 = traces()
        self._fallbacks0 = fallbacks()
        self._launches0 = launches()

    @property
    def traces(self) -> int:
        return traces() - self._traces0

    @property
    def fallbacks(self) -> int:
        return fallbacks() - self._fallbacks0

    @property
    def launches(self) -> int:
        return launches() - self._launches0


@contextlib.contextmanager
def watch(*, reset_warnings: bool = False):
    """Context manager yielding a `CounterWatch` over the enclosed work.

    ``reset_warnings=True`` additionally re-arms the once-per-reason
    fallback warnings at entry (the per-plan semantics `run_plan` wants).
    """
    if reset_warnings:
        reset_fallback_warnings()
    yield CounterWatch()
