"""PyTorch + CUDA port of the MLTCP reproduction (the JAX package `repro`
is the reference it is held against).

Slice 1 covers the simulator's main path: the protocol (`core`), the
fused CC-tick kernel (`kernels`), the fluid fabric with its sweep axis
(`netsim`) and the paper's job profiles (`workload`).  Every state and
sweep tensor carries a leading ``[K]`` sweep axis; everything is float32.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
from repro_torch import core, kernels, netsim, workload  # noqa: F401

__all__ = ["core", "kernels", "netsim", "workload"]
