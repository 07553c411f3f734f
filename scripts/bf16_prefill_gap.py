#!/usr/bin/env python3
"""Each package's bf16 prefill against the float32 prefill of the same
weights, and against each other, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/bf16_prefill_gap.py \
        xlstm-125m [ARCH ...]

It runs `tests/test_torch_models.py`'s bf16 prefill case of each
architecture (the same scaled-down config, weights, prompt and
``_prefill_both``) and prints, as a share of the float32 reference's
largest |value|, the largest error of the logits and of every cache array:
the reference's bf16 against float32, the port's bf16 against float32, and
the two bf16 results against each other (what the test holds within
``BF16_REL_TOL``).  Where both packages are as far from float32 as from
each other, the gap is bf16's, not a fault of either.  ~10-30 s an
architecture.
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    archs = sys.argv[1:] if argv is None else argv
    sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "src")]
    import jax
    import test_torch_models as t

    from repro_torch.models import convert

    def err(got, want, scale):
        return float(np.abs(np.asarray(got, np.float32)
                            - np.asarray(want, np.float32)).max() / scale)
    for arch in archs:
        s = t._setup(arch)
        rl32, rc32, _, _ = t._prefill_both(s, "float32")
        rl, rc, pl, pc = t._prefill_both(s, "bfloat16")
        f32 = np.asarray(rl32, np.float32)
        scale = float(np.abs(f32).max())
        pl = pl.float().numpy()
        print(f"{arch} logits: reference {err(rl, f32, scale):.4g}, "
              f"port {err(pl, f32, scale):.4g}, "
              f"between {err(pl, rl, scale):.4g}")
        want = t._leaves(jax.device_get(rc32))
        ref = t._leaves(jax.device_get(rc))
        got = t._leaves(convert.cache_to_reference_layout(
            s["pcfg"], t._float32(pc)))
        for (path, w), (_, r), (_, g) in zip(want, ref, got):
            if path[-1] == "pos":
                continue
            sc = max(float(np.abs(np.asarray(w, np.float32)).max()), 1e-30)
            g = np.asarray(g)
            print(f"  {'/'.join(path)}: reference {err(r, w, sc):.4g}, "
                  f"port {err(g, w, sc):.4g}, between {err(g, r, sc):.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
