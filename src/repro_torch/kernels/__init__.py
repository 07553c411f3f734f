"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel module holds a CUDA kernel's wrapper (``csrc/<name>.cu``), its
launch counter and its library (`build.KernelLibrary`); `ref` holds the
language-model kernels' plain PyTorch versions, `mltcp_step` its own.

  mltcp_step       fused CC tick (the simulator's path)
  flash_attention  attention forward (the language-model path)
  rg_lru           RG-LRU scan (the language-model path)

`ops` dispatches to them.  Importing this package builds nothing: each
kernel is compiled at its first launch.
"""
from repro_torch.kernels import (build, flash_attention, mltcp_step,  # noqa: F401
                                 ops, ref, rg_lru)
