"""Assigned input shapes (identical set for every LM-family architecture).

  train_4k     seq 4096,    global batch 256  -> train_step
  prefill_32k  seq 32768,   global batch 32   -> serve_step (prefill)
  decode_32k   seq 32768,   global batch 128  -> serve_step (1 token, KV cache)
  long_500k    seq 524288,  global batch 1    -> serve_step (decode; only for
               sub-quadratic archs — skips recorded per DESIGN.md §5)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
