"""The engine's random bits, bit for bit as the reference draws them.

The reference seeds ``jax.random.PRNGKey(seed)`` and splits the key five
ways every tick (``jax.random.split(key, 5)``), then turns two subkeys
into per-flow and two into per-job uniforms with a keyed murmur3 hash of
the lane index (`lane_uniform`).  Under jax 0.9's default
``jax_threefry_partitionable=True``, ``split(key, n)[i]`` is the threefry2x32
block of counter ``(0, i)`` under ``key``.

None of this depends on the simulation state, only on the seed and the
tick, so it runs on the host in numpy: uint32 arithmetic there wraps
modulo 2^32 by definition (the torch alternative would be int64 masked
after every op, with multiplies split into 16-bit halves), and a whole
chunk of ticks is drawn at once (`chunk_draws`) and shipped to the device
in one copy, instead of a few hundred tiny integer kernels per tick.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (jax's ``threefry2x32_p``), elementwise
    over broadcastable uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(v, U32) for v in (k0, k1, x0, x1))
    k0, k1, x0, x1 = np.broadcast_arrays(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def _threefry_ints(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """`threefry2x32` on python ints (one block; the chain's fast path)."""
    m = 0xFFFFFFFF
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & m
    x1 = (x1 + k1) & m
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & m
            x1 = ((x1 << r) & m) | (x1 >> (32 - r))
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & m
    return x0, x1


def prng_key(seed) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for int32 seeds: uint32 ``[hi, lo]`` of
    the 64-bit seed, so ``[0, seed mod 2^32]``; batched over a leading
    axis of seeds ([K] -> [K, 2])."""
    s = np.asarray(seed).astype(np.int64)
    lo = (s & 0xFFFFFFFF).astype(U32)
    hi = np.zeros_like(lo)
    return np.stack([hi, lo], axis=-1)


def split(key: np.ndarray, num: int) -> np.ndarray:
    """``jax.random.split(key, num)``: [..., 2] -> [..., num, 2]."""
    key = np.asarray(key, U32)
    counts = np.arange(num, dtype=U32)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          np.zeros_like(counts), counts)
    return np.stack([b0, b1], axis=-1)


def mix32(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer — a cheap full-avalanche bijection."""
    x = np.asarray(x, U32)
    x = x ^ (x >> U32(16))
    x = x * U32(0x85EBCA6B)
    x = x ^ (x >> U32(13))
    x = x * U32(0xC2B2AE35)
    x = x ^ (x >> U32(16))
    return x


def lane_uniform(key: np.ndarray, n: int) -> np.ndarray:
    """Per-lane U[0,1) float32 draws where lane i depends only on (key, i)
    (the reference's ``_lane_uniform``); ``key`` is [..., 2] and the
    result [..., n].  Lane stability is what keeps a padded fabric's
    first n lanes equal to an unpadded run's."""
    key = np.asarray(key, U32)
    lanes = np.arange(n, dtype=U32)
    h = mix32(lanes ^ key[..., 0, None])
    h = mix32(h ^ key[..., 1, None])
    # top 24 bits -> [0, 1) at float32 resolution
    return (h >> U32(8)).astype(np.float32) * np.float32(1 / (1 << 24))


class ChunkDraws(NamedTuple):
    """One chunk's draws: ``keys[t]`` is the key after tick t; ``loss`` /
    ``cnp`` are [T, K, N] and ``strag`` / ``samt`` [T, K, J] uniforms."""

    keys: np.ndarray
    loss: np.ndarray
    cnp: np.ndarray
    strag: np.ndarray
    samt: np.ndarray


def chunk_draws(key: np.ndarray, n_ticks: int, n_flows: int,
                n_jobs: int) -> ChunkDraws:
    """The key stream and uniforms of ``n_ticks`` ticks from ``key`` [K, 2].

    Each tick splits its key five ways, as the reference tick does: the
    next key, then the loss, CNP, straggle and straggle-amount subkeys.
    The chain of next keys is sequential (python ints, one block per tick
    and point); the four subkeys and the uniforms are computed for all
    ticks at once.
    """
    key = np.asarray(key, U32)
    chain = np.empty((n_ticks + 1,) + key.shape, U32)
    chain[0] = key
    for idx in np.ndindex(key.shape[:-1]):
        k0, k1 = int(key[idx + (0,)]), int(key[idx + (1,)])
        col = chain[(slice(None),) + idx]
        for t in range(n_ticks):
            k0, k1 = _threefry_ints(k0, k1, 0, 0)
            col[t + 1] = (k0, k1)
    # subkey i of tick t is block (0, i) under the tick's key
    subs = split(chain[:-1], 5)
    return ChunkDraws(
        keys=chain[1:],
        loss=lane_uniform(subs[..., 1, :], n_flows),
        cnp=lane_uniform(subs[..., 2, :], n_flows),
        strag=lane_uniform(subs[..., 3, :], n_jobs),
        samt=lane_uniform(subs[..., 4, :], n_jobs))
