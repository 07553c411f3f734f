"""PyTorch + CUDA port of the MLTCP reproduction (the JAX package `repro`
is the reference it is held against).

Slice 1 covers the simulator's main path: the protocol (`core`), the
fused CC-tick kernel (`kernels`), the fluid fabric with its sweep axis
(`netsim`) and the paper's job profiles (`workload`).  Every state and
sweep tensor carries a leading ``[K]`` sweep axis; everything is float32.

Slice 2 covers serving a decoder-only language model: the configs
(`configs`), the model stack (`models`), the serving steps (`train`) and
launcher (`launch.serve`), with the flash-attention and RG-LRU scan
kernels (`kernels`).

Slice 8 trains: the optimizer (`optim`), the training step (`train`),
the data pipeline (`data`), checkpoints (`checkpoint`) and the launcher
(`launch.train`), with backward passes for both language-model kernels;
and the shared-cluster driver (`cluster`) on the card's constants
(`roofline`).

Slice 9 adds the remaining model families to `models`: MoE (`moe`),
xLSTM (`xlstm`) and the encoder-decoder (`encdec`, with cross-attention),
so all ten configs build, serve and train.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
from repro_torch import configs, core, kernels, models, netsim, train  # noqa: F401
from repro_torch import workload  # noqa: F401

__all__ = ["configs", "core", "kernels", "models", "netsim", "train",
           "workload"]
