"""Batched serving demo: prefill a prompt batch, then greedy-decode with KV
(and recurrent-state) caches.

The port of ``examples/serve_lm.py``: the serving launcher
(`launch.serve.main`), whose options it takes; with none it serves
qwen3-1.7b, as the reference's script does.  On the card the prefill
runs the flash-attention and RG-LRU kernels where the model has them
(recurrentgemma-2b has both):

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --arch recurrentgemma-2b
"""
from __future__ import annotations

from repro_torch.launch import serve


def main(argv=None) -> dict:
    """`launch.serve.main`: returns its `serve` result."""
    return serve.main(argv)


if __name__ == "__main__":
    main()
