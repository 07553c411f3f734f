"""Load the JAX reference package for the port's parity tests.

Under jax 0.9, ``import repro.core`` fails at ``core/iteration.py:46``:
``_barrier_p not in _batching.primitive_batchers`` raises ``TypeError``
because jax's batcher registry proxy has no ``__contains__``.  The
reference stays as it is, so the port's tests import it through
`load_reference`, which swaps the registry for a wrapper whose
``__contains__`` answers True (jax 0.9 ships the barrier's batching rule
itself, so skipping the registration loses nothing), imports the modules
the tests need, and restores the original registry.

It then takes the reference's modules back out of ``sys.modules`` (the
tests keep the module objects): a test worker imports every test file,
and the reference's own test files must keep importing ``repro`` as they
always do, unaided.
"""
from __future__ import annotations

import importlib
import sys
import types

_MODULES = ("repro.core", "repro.netsim", "repro.kernels.ops",
            "repro.kernels.mltcp_step", "repro.workload")
_loaded: dict[str, types.ModuleType] = {}


class _AnswersContains:
    """The registry with a ``__contains__`` that always answers True."""

    def __init__(self, inner):
        self._inner = inner

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        return self._inner[key]

    def __setitem__(self, key, value):
        self._inner[key] = value

    def __getattr__(self, name):
        return getattr(self._inner, name)


def load_reference() -> dict[str, types.ModuleType]:
    """Import the reference modules once; returns them by dotted name."""
    if _loaded:
        return _loaded
    from jax.interpreters import batching

    original = batching.primitive_batchers
    before = set(sys.modules)
    batching.primitive_batchers = _AnswersContains(original)
    try:
        for name in _MODULES:
            _loaded[name] = importlib.import_module(name)
    finally:
        batching.primitive_batchers = original
        added = {name for name in set(sys.modules) - before
                 if name == "repro" or name.startswith("repro.")}
        for name in added:
            module = sys.modules.pop(name)
            # a package that was there before keeps no handle on it either
            parent, _, child = name.rpartition(".")
            if (parent not in added
                    and getattr(sys.modules.get(parent), child, None)
                    is module):
                delattr(sys.modules[parent], child)
    return _loaded


def ulp_diff(a, b):
    """Elementwise distance in float32 units in the last place (0 where
    both are equal, including equal NaN positions)."""
    import numpy as np

    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)

    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = np.abs(ordered(a) - ordered(b))
    both_nan = np.isnan(a) & np.isnan(b)
    return np.where(both_nan | (a == b), 0, d)


def assert_ulp(got, want, max_ulp: int, what: str = "") -> None:
    """Assert every element of ``got`` is within ``max_ulp`` float32 ulps
    of ``want`` (NaNs must sit in the same places)."""
    import numpy as np

    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaNs"
    d = ulp_diff(got, want)
    worst = int(d.max()) if d.size else 0
    assert worst <= max_ulp, (
        f"{what}: {worst} ulp > {max_ulp} (at {np.unravel_index(d.argmax(), d.shape)}: "
        f"got {got.flat[d.argmax()]!r}, want {want.flat[d.argmax()]!r})")


# ---------------------------------------------------------------------------
# Shared fuzz inputs: numpy values handed to both packages
# ---------------------------------------------------------------------------

def random_protocol_arrays(rng, shape) -> dict:
    """A mid-run protocol state as numpy arrays (float32 / int32), in the
    ranges `tests/test_kernels.py` fuzzes the reference kernel with."""
    import numpy as np

    def u(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    det = dict(bytes_sent=u() * np.float32(1e8), bytes_ratio=u(),
               prev_ack_tstamp=u() * np.float32(0.01),
               iter_gap=u(1e-3, 0.05), max_gap=u(1e-3, 0.05),
               n_boundaries=rng.integers(0, 5, shape).astype(np.int32))
    cc = dict(cwnd=u(1.0, 500.0), ssthresh=u(10.0, 1e4),
              cooldown=u() * np.float32(2e-4), w_max=u(1.0, 500.0),
              epoch_start=u() * np.float32(0.01), rate_cur=u(1e6, 6e9),
              rate_target=u(1e6, 6e9), alpha=u(),
              t_last_cnp=u() * np.float32(0.01),
              t_last_inc=u() * np.float32(0.01),
              t_last_alpha=u() * np.float32(0.01),
              inc_stage=rng.integers(0, 10, shape).astype(np.int32))
    return {"cc": cc, "det": det}


def random_feedback_arrays(rng, shape) -> dict:
    import numpy as np

    has = rng.uniform(size=shape) < 0.7
    return dict(num_acks=np.where(has, rng.uniform(0, 40, shape), 0.0)
                .astype(np.float32),
                loss=rng.uniform(size=shape) < 0.2,
                cnp=rng.uniform(size=shape) < 0.3)
