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

Some reference code imports lazily: ``counters.traces`` imports
``repro.netsim.engine`` when called (``run_plan`` calls it), and the
models' ``use_kernel=True`` path imports ``repro.kernels.ops``.  With the
reference out of ``sys.modules`` such an import would build a second copy
of the package and die at the same line.  A test calls such code inside
``with reference_modules():``, which puts every module `load_reference`
kept back into ``sys.modules``, under the shim, for the block's length.
"""
from __future__ import annotations

import contextlib
import importlib
import sys
import types

_MODULES = ("repro.core", "repro.netsim", "repro.netsim.experiment",
            "repro.netsim.counters", "repro.kernels.ops",
            "repro.kernels.mltcp_step", "repro.workload",
            # the training side and the shared-cluster driver
            "repro.optim", "repro.optim.adamw", "repro.optim.grad_compress",
            "repro.train.train_step", "repro.data",
            "repro.checkpoint", "repro.launch.train", "repro.roofline.hw",
            "repro.cluster", "repro.models.api", "repro.configs",
            # the static verifier (its plan registry imports benchmarks/
            # lazily, inside reference_modules())
            "repro.analysis")
_loaded: dict[str, types.ModuleType] = {}
# every reference module the imports brought in, by dotted name: what
# `reference_modules` puts back
_kept: dict[str, types.ModuleType] = {}


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


def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@contextlib.contextmanager
def _shimmed():
    from jax.interpreters import batching

    original = batching.primitive_batchers
    batching.primitive_batchers = _AnswersContains(original)
    try:
        yield
    finally:
        batching.primitive_batchers = original


def load_reference() -> dict[str, types.ModuleType]:
    """Import the reference modules once; returns them by dotted name."""
    if _loaded:
        return _loaded
    before = set(sys.modules)
    try:
        with _shimmed():
            for name in _MODULES:
                _loaded[name] = importlib.import_module(name)
    finally:
        added = {name for name in set(sys.modules) - before
                 if _is_reference(name)}
        for name in added:
            module = sys.modules.pop(name)
            _kept[name] = module
            # a package that was there before keeps no handle on it either
            parent, _, child = name.rpartition(".")
            if (parent not in added
                    and getattr(sys.modules.get(parent), child, None)
                    is module):
                delattr(sys.modules[parent], child)
    return _loaded


@contextlib.contextmanager
def reference_modules():
    """For the block's length ``sys.modules`` holds the reference's modules
    (the objects `load_reference` returned) and the shim is in place, so
    the reference's lazy imports find them.  On exit the ``repro`` modules
    that were there before come back, and a module the block imported is
    kept for the next block."""
    load_reference()
    saved = {name: sys.modules.pop(name) for name in list(sys.modules)
             if _is_reference(name)}
    sys.modules.update(_kept)
    try:
        with _shimmed():
            yield _loaded
    finally:
        for name in list(sys.modules):
            if _is_reference(name):
                _kept[name] = sys.modules.pop(name)
        sys.modules.update(saved)


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


def reference_layer(tree: dict, slot) -> dict:
    """The reference parameter (or cache) subtree of one layer of the
    decoder stack, as numpy arrays; ``slot`` is the layer's (section, key,
    group) from ``repro_torch.models.convert._layer_slots``."""
    import numpy as np

    section, key, g = slot

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        return np.asarray(x) if g is None else np.asarray(x)[g]
    return take(tree[section][key])


def loss_and_grads(arch: str, batch: dict, **overrides) -> dict:
    """`train_step.loss_fn` and its gradients in both packages, for
    ``arch`` scaled down with ``overrides``, on ``batch`` (numpy arrays),
    with the reference's initial parameters carried into the port: the
    two losses and auxiliary losses, and per gradient leaf (by the
    reference's path) the max |port - reference| and the leaf's max
    |reference|.  The reference runs with its defaults (``use_kernel``
    False, remat), the port on the CPU likewise."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import convert
    from repro_torch.train import TrainHyper, loss_fn

    ref = load_reference()
    rts = ref["repro.train.train_step"]
    rcfg = ref["repro.configs"].get_config(arch).scaled_down(**overrides)
    pcfg = get_config(arch).scaled_down(**overrides)
    rparams = ref["repro.models.api"].init_params(rcfg,
                                                  jax.random.PRNGKey(0))
    rh = rts.TrainHyper()
    (rloss, rmetrics), rgrads = jax.value_and_grad(
        lambda p: rts.loss_fn(rcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, rh),
        has_aux=True)(rparams)
    model = convert.params_from_reference(pcfg, jax.device_get(rparams),
                                          device="cpu")
    params = dict(model.named_parameters())
    ploss, pmetrics = loss_fn(pcfg, model, {k: torch.from_numpy(v)
                                            for k, v in batch.items()},
                              TrainHyper())
    pgrads = dict(zip(params, torch.autograd.grad(ploss,
                                                  list(params.values()))))

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                for k, v in jax.tree_util.tree_flatten_with_path(
                    jax.device_get(tree))[0]}
    got, want = flat(convert.params_to_reference(pcfg, pgrads)), flat(rgrads)
    assert got.keys() == want.keys(), set(got) ^ set(want)
    return dict(loss=(float(ploss.detach()), float(rloss)),
                aux=(float(pmetrics["aux"].detach()),
                     float(rmetrics["aux"])),
                grads={k: (float(np.abs(got[k] - want[k]).max()),
                           float(np.abs(want[k]).max())) for k in want})
