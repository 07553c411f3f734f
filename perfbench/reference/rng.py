"""The simulator's random draws, computed again from the seed.

Integer arithmetic only, so it gives the same bits on every machine:

* a point's key is ``[0, seed mod 2^32]``;
* every tick splits the key five ways: block ``(0, i)`` of Threefry-2x32
  (20 rounds) under the tick's key is subkey i, subkey 0 is the next
  tick's key;
* subkeys 1-4 become the loss, CNP, straggle and straggle-amount
  uniforms: lane n of a draw is the top 24 bits of murmur3's finalizer
  applied to ``n ^ key[0]`` and then ``^ key[1]``, times 2^-24.

`chunk_uniforms` returns a chunk's draws, with the key chain walked tick
by tick over all points at once.
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = U32(0x1BD11BDA)


def seed_keys(seeds) -> np.ndarray:
    """[K] seeds -> [K, 2] keys ``[0, seed mod 2^32]``."""
    s = np.asarray(seeds).astype(np.int64)
    lo = (s & 0xFFFFFFFF).astype(U32)
    return np.stack([np.zeros_like(lo), lo], axis=-1)


def _mix32(x):
    x = x ^ (x >> U32(16))
    x = x * U32(0x85EBCA6B)
    x = x ^ (x >> U32(13))
    x = x * U32(0xC2B2AE35)
    return x ^ (x >> U32(16))


def lane_uniform(key: np.ndarray, n: int) -> np.ndarray:
    """[..., 2] keys -> [..., n] float32 uniforms in [0, 1)."""
    lanes = np.arange(n, dtype=U32)
    h = _mix32(lanes ^ key[..., 0, None])
    h = _mix32(h ^ key[..., 1, None])
    return (h >> U32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def _chain_step(k0, k1, x0, x1, t0, t1):
    """Blocks (0, c) of Threefry-2x32 under keys (k0, k1), in place on the
    preallocated uint32 arrays x0, x1 (scratch t0, t1): the chain's
    per-tick step, written to spare allocations."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    np.add(x0, k0, out=x0)
    np.add(x1, k1, out=x1)
    for i in range(5):
        for r in _ROT[i % 2]:
            np.add(x0, x1, out=x0)
            np.left_shift(x1, U32(r), out=t0)
            np.right_shift(x1, U32(32 - r), out=t1)
            np.bitwise_or(t0, t1, out=x1)
            np.bitwise_xor(x1, x0, out=x1)
        np.add(x0, ks[(i + 1) % 3], out=x0)
        np.add(x1, ks[(i + 2) % 3], out=x1)
        np.add(x1, U32(i + 1), out=x1)


def chunk_uniforms(key: np.ndarray, n_ticks: int, n_flows: int,
                   n_jobs: int):
    """The draws of ``n_ticks`` ticks from ``key`` [K, 2].

    Returns (key after the chunk, loss [T, K, N], cnp [T, K, N],
    straggle [T, K, J], straggle amount [T, K, J])."""
    k = key.shape[0]
    subs = np.empty((n_ticks, k, 4, 2), U32)
    counters = np.broadcast_to(np.arange(5, dtype=U32), (k, 5))
    k0 = np.ascontiguousarray(np.broadcast_to(key[:, 0:1], (k, 5)))
    k1 = np.ascontiguousarray(np.broadcast_to(key[:, 1:2], (k, 5)))
    x0, x1, t0, t1 = (np.empty((k, 5), U32) for _ in range(4))
    for t in range(n_ticks):
        x0.fill(0)
        np.copyto(x1, counters)
        _chain_step(k0, k1, x0, x1, t0, t1)
        subs[t, :, :, 0] = x0[:, 1:]
        subs[t, :, :, 1] = x1[:, 1:]
        k0[:] = x0[:, 0:1]
        k1[:] = x1[:, 0:1]
    nxt = np.stack([k0[:, 0], k1[:, 0]], axis=1)
    return (nxt, lane_uniform(subs[:, :, 0], n_flows),
            lane_uniform(subs[:, :, 1], n_flows),
            lane_uniform(subs[:, :, 2], n_jobs),
            lane_uniform(subs[:, :, 3], n_jobs))
