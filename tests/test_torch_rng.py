"""The port's random bits against jax's, bit for bit.

The engine's loss/CNP/straggler draws come from ``jax.random.PRNGKey`` and
``jax.random.split(key, 5)`` (threefry2x32, partitionable) hashed per lane
by ``_mix32``/``_lane_uniform``; `repro_torch.netsim.random` recomputes
them on the host.  Integer arithmetic only, so equality is exact.
"""
import numpy as np
import pytest

from _torch_reference import load_reference

import jax
import jax.numpy as jnp

from repro_torch.netsim import random as trng

REF = load_reference()
ref_engine = REF["repro.netsim"].engine

# jitted once: 200 eager splits per seed would cost seconds of dispatch
split5 = jax.jit(lambda k: jax.random.split(k, 5))
lane_uniform = jax.jit(ref_engine._lane_uniform, static_argnums=1)

SEEDS = [0, 1, 3, 12345, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_stream_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    mine = trng.prng_key(seed)
    assert mine.dtype == np.uint32
    np.testing.assert_array_equal(mine, np.asarray(key))
    for _ in range(200):
        want = np.asarray(split5(key))
        got = trng.split(mine, 5)
        np.testing.assert_array_equal(got, want)
        key, mine = want[0], got[0]


def test_batched_key_stream_matches_per_seed():
    """chunk_draws over [K] seeds == the split chain of each seed."""
    seeds = np.asarray([0, 7, 2**31 - 1])
    draws = trng.chunk_draws(trng.prng_key(seeds), 50, 5, 3)
    for i, seed in enumerate(seeds):
        key = jax.random.PRNGKey(int(seed))
        for t in range(50):
            sub = split5(key)
            np.testing.assert_array_equal(
                draws.loss[t, i], np.asarray(lane_uniform(sub[1], 5)))
            np.testing.assert_array_equal(
                draws.samt[t, i], np.asarray(lane_uniform(sub[4], 3)))
            key = sub[0]
            np.testing.assert_array_equal(draws.keys[t, i], np.asarray(key))


@pytest.mark.parametrize("n", [1, 2, 7, 128, 1000, 4097])
def test_mix32_and_lane_uniform_match_reference(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        trng.mix32(x), np.asarray(ref_engine._mix32(jnp.asarray(x))))
    for seed in (0, 2**31 - 1):
        key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
        got = trng.lane_uniform(np.asarray(key), n)
        want = np.asarray(ref_engine._lane_uniform(key, n))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
