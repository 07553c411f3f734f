"""Hand-written Hopper kernels of the port and their wrappers.

`mltcp_step` holds the fused CC-tick CUDA kernel (``csrc/mltcp_step.cu``),
its plain PyTorch version, its build and its launch counter; `ops` makes
it a drop-in for `core.cc_tick`.  Importing this package builds nothing:
the kernel is compiled at its first launch.
"""
from repro_torch.kernels import mltcp_step, ops  # noqa: F401
