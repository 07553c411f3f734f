"""Training launcher (the port of ``repro/launch/train.py``).

The ``smoke`` preset trains a reduced same-family config (``scaled_down``);
``full`` trains the published config on one card.  Both run the real data
pipeline, AdamW, checkpointing and restart.  On the card the forward and
its rematerialization run the flash and RG-LRU kernels, and the RG-LRU
backward runs the scan kernel again.  Runs on the CUDA card unless
``device`` says otherwise (``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 60 --seq-len 48 --batch 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --preset full --steps 3 --seq-len 4096 \\
      --batch 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataConfig, make_batch_iterator
from repro_torch.device import resolve
from repro_torch.optim import CompressionConfig
from repro_torch.train import TrainHyper, init_train_state, make_train_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(arch: str, steps: int = 100, seq_len: int = 128, batch: int = 8,
          ckpt_dir: str | None = None, resume: bool = False,
          ckpt_every: int = 50, preset: str = "smoke", seed: int = 0,
          compression: str = "none", log_every: int = 10,
          device=None) -> dict:
    """Train ``arch`` to step ``steps`` (from the latest checkpoint in
    ``ckpt_dir`` with ``resume``), saving every ``ckpt_every`` steps and at
    the end.  Returns the mean of the first and of the last ten losses,
    the steps run, and per step its loss, gradient norm and host-clock
    seconds (around a synchronized step)."""
    dev = resolve(device)
    cfg = get_config(arch)
    if preset == "smoke":
        cfg = cfg.scaled_down()
    elif preset != "full":
        raise ValueError(f"unknown preset {preset!r}")
    hyper = TrainHyper(warmup=max(steps // 20, 5), total_steps=steps,
                       compression=CompressionConfig(scheme=compression))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_train_state(cfg, hyper, gen, dev)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if resume and mgr and mgr.latest_step() is not None:
        state = mgr.restore(state)
        start_step = int(state.step)
        print(f"resumed from step {start_step}")

    dc = DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
                    seed=seed,
                    frames=(seq_len // cfg.enc_seq_divisor
                            if cfg.family == "audio" else 0),
                    frame_dim=cfg.d_model if cfg.family == "audio" else 0,
                    vision_tokens=cfg.vision_tokens,
                    vit_dim=cfg.vit_dim)
    it = make_batch_iterator(dc, start_step=start_step, device=dev)
    step_fn = make_train_step(cfg, hyper)

    losses, grad_norms, step_s = [], [], []
    t0 = time.time()
    for i in range(start_step, steps):
        b = next(it)
        _sync(dev)
        t1 = time.perf_counter()
        state, metrics = step_fn(state, b)
        _sync(dev)
        step_s.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"gnorm {grad_norms[-1]:.3f} "
                  f"({(time.time() - t0) / max(i - start_step + 1, 1):.2f}"
                  f" s/step)")
        if mgr and (i + 1) % ckpt_every == 0:
            mgr.save(i + 1, state)
    if mgr:
        mgr.save(steps, state, blocking=True)
    first = float(np.mean(losses[:10])) if len(losses) >= 10 else losses[0]
    last = float(np.mean(losses[-10:]))
    return {"first_loss": first, "last_loss": last, "steps": len(losses),
            "losses": losses, "grad_norms": grad_norms, "step_s": step_s,
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--preset", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", choices=("none", "topk", "int8"),
                    default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, seq_len=args.seq_len,
                batch=args.batch, ckpt_dir=args.ckpt_dir,
                resume=args.resume, ckpt_every=args.ckpt_every,
                preset=args.preset, seed=args.seed,
                compression=args.compression, log_every=args.log_every,
                device=args.device)
    print(f"loss {out['first_loss']:.3f} -> {out['last_loss']:.3f} "
          f"over {out['steps']} steps on {out['device']}")


if __name__ == "__main__":
    main()
