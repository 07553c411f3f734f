"""Quickstart: train a small LM end-to-end and watch the loss drop.

The port of ``examples/quickstart.py``: the xlstm-125m family at reduced
width (the ``smoke`` preset), the synthetic Zipf+motif pipeline, AdamW
with a cosine schedule, and checkpoints every 60 steps: the same code
path the training launcher (`launch.train`) uses.  It runs on the card
unless ``--device cpu``.  xLSTM has no attention and no RG-LRU block, so
this run launches none of the port's three kernels (flash attention, the
RG-LRU scan, the chunk kernel): its mLSTM and sLSTM blocks are plain
PyTorch.

The checkpoints go to ``--ckpt-dir``, or else to a temporary directory of
the run's own that is removed at the end.  ``--steps`` cuts the run.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import train

STEPS = 120


def main(argv=None) -> dict:
    """Train, print the loss drop and assert it; returns `train`'s
    result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="training steps (default %(default)s)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_torch_quickstart_") as tmp:
        out = train("xlstm-125m", steps=args.steps, seq_len=64, batch=8,
                    ckpt_dir=args.ckpt_dir or tmp, ckpt_every=60,
                    device=args.device)
    print(f"\nloss {out['first_loss']:.3f} -> {out['last_loss']:.3f}")
    if not out["last_loss"] < out["first_loss"]:
        raise AssertionError("model failed to learn")
    print("quickstart OK: the model is learning.")
    return out


if __name__ == "__main__":
    main()
