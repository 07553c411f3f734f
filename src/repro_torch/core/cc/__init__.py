"""Congestion-control algorithms augmented by MLTCP (paper §3.4).

Each algorithm is a pure function over the unified per-flow state
(`repro_torch.core.cc.types.FlowCCState`, ``[K, N]`` tensors), so one
update serves the engine, the fused kernel's plain version and the tests.
"""

from repro_torch.core.cc import cubic, dcqcn, reno  # noqa: F401
