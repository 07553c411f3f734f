"""Synthetic-but-structured token pipeline (the port of
``repro/data/pipeline.py``).

Deterministic per (seed, step, host): every host materializes only its
shard of the global batch (``host_id``/``n_hosts``).  The stream is a
mixture of Zipf-distributed unigrams and short copied motifs, which gives
a model a learnable signal.  The tokens are drawn by the reference's own
numpy code, so both packages train on the same batches; the port hands
them over as torch tensors on the requested device.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    # modality extras (stub frontends)
    frames: int = 0
    frame_dim: int = 0
    vision_tokens: int = 0
    vit_dim: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _zipf_motif_tokens(rng: np.random.Generator, b: int, t: int,
                       vocab: int) -> np.ndarray:
    # Zipf unigrams
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(b, t), p=probs)
    # splice short copied motifs (predictable structure => learnable)
    for i in range(b):
        motif_len = int(rng.integers(4, 12))
        motif = rng.choice(vocab, size=motif_len)
        reps = max(1, t // (motif_len * 4))
        for r in range(reps):
            start = int(rng.integers(0, max(t - motif_len, 1)))
            toks[i, start: start + motif_len] = motif[: t - start]
    return toks.astype(np.int32)


def synthetic_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """One host-local batch for ``step`` (a pure function of cfg and step):
    ``tokens`` [host_batch, seq_len] int32, and float32 ``frames`` /
    ``patches`` where the config asks for them, on ``device`` (None: the
    CUDA card)."""
    dev = resolve(device)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    b = cfg.host_batch
    batch = {"tokens": _zipf_motif_tokens(rng, b, cfg.seq_len, cfg.vocab)}
    if cfg.frames:
        batch["frames"] = rng.standard_normal(
            (b, cfg.frames, cfg.frame_dim), dtype=np.float32)
    if cfg.vision_tokens:
        batch["patches"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vit_dim), dtype=np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def make_batch_iterator(cfg: DataConfig, start_step: int = 0,
                        prefetch: int = 2, device=None) -> Iterator[dict]:
    """Batches from ``start_step`` on, ``prefetch`` steps drawn ahead."""
    queue: collections.deque = collections.deque()
    step = start_step
    while True:
        while len(queue) < prefetch + 1:
            queue.append(synthetic_batch(cfg, step, device))
            step += 1
        yield queue.popleft()
