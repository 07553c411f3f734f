"""Serving launcher: batched prefill + greedy decode on any assigned arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --preset full --batch 4 --prompt-len 4096 --new 16

The port of ``repro/launch/serve.py``.  Unlike the reference launcher, the
prefill runs through the kernels (``use_kernel=True``): flash attention and
the RG-LRU scan, where the model has them.  Weights are random, drawn from
``seed``, and so are an audio model's frames (``max(prompt_len // 4, 4)``
of them, the reference's request) and a vision model's patches.  Runs on the
CUDA card unless ``device`` says otherwise (``--device cpu``).  ``dtype``
(``--dtype``) is the parameters' and so the cache's dtype: float32, or
bfloat16 as the reference's dry run serves (``SERVE_DTYPE``); frames and
patches stay float32, as the reference's are.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve
from repro_torch.models import api
from repro_torch.train import make_decode_step, make_prefill_step
from repro_torch.train.serve_step import prompt_length


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int = 4, prompt_len: int = 32,
          new_tokens: int = 16, preset: str = "smoke", seed: int = 0,
          device=None, dtype: str = "float32") -> dict:
    """Prefill a random prompt of ``batch`` rows, then decode greedily.

    Returns the generated ids [B, new_tokens], the prefill time, the decode
    rate (tokens over the ``new_tokens - 1`` decode steps), and the config,
    model and request, so a caller can run the same prompt again."""
    dev = resolve(device)
    cfg = get_config(arch)
    if preset == "smoke":
        cfg = cfg.scaled_down()
    elif preset != "full":
        raise ValueError(f"unknown preset {preset!r}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = api.init_params(cfg, gen, dev).requires_grad_(False)
    model.to(getattr(torch, dtype))
    max_len = prompt_len + new_tokens + 8

    req = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                   generator=gen, device=dev)}
    if cfg.family == "audio":
        req["frames"] = torch.randn(
            (batch, max(prompt_len // cfg.enc_seq_divisor, 4), cfg.d_model),
            generator=gen, device=dev)
    if cfg.family == "vlm":
        req["patches"] = torch.randn((batch, cfg.vision_tokens, cfg.vit_dim),
                                     generator=gen, device=dev)

    prefill = make_prefill_step(cfg, max_len=max_len, use_kernel=True)
    decode = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    tok, cache = prefill(model, req)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    pos0 = prompt_length(cfg, req)
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        tok, cache = decode(model, cache, tok, pos0 + i)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return {
        "generated": torch.stack(out, dim=1),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (new_tokens - 1) / max(t_decode, 1e-9),
        "device": str(dev),
        "cfg": cfg, "model": model, "request": req, "max_len": max_len,
    }


def main(argv=None) -> dict:
    """Serve from the command line's options, print the generated ids and
    the timings; returns `serve`'s result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--preset", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.new, preset=args.preset, seed=args.seed,
                device=args.device, dtype=args.dtype)
    print("generated ids:\n", out["generated"].cpu())
    print(f"prefill {out['prefill_s'] * 1e3:.1f} ms; decode "
          f"{out['decode_tok_per_s']:.1f} tok/s on {out['device']}")
    return out


if __name__ == "__main__":
    main()
