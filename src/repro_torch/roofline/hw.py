"""Hardware constants: the port's card (the port of
``repro/roofline/hw.py``, whose one constant describes a TPU).

The fields keep the reference's names, so the cluster profiles' arithmetic
is the reference's; on the card ``ici_link_bw`` is one NVLink link.
``peak_flops_f32`` is the port's own field (its default is the H100's),
for the roofline of a float32 cell (`roofline.analysis`).
"""
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip, dense
    hbm_bw: float               # bytes/s per chip
    ici_link_bw: float          # bytes/s per link (one way)
    hbm_bytes: float            # capacity per chip
    # FLOP/s per chip in float32 outside the tensor cores (H100 SXM5)
    peak_flops_f32: float = 67e12

    def peak_flops(self, dtype: torch.dtype) -> float:
        """The peak for a cell computed in ``dtype``: float32's, else
        bf16's."""
        return (self.peak_flops_f32 if dtype == torch.float32
                else self.peak_flops_bf16)


# NVIDIA H100 SXM5 80 GB, data-sheet values (NVIDIA H100 Tensor Core GPU
# data sheet and the Hopper architecture white paper): 989 TFLOP/s dense
# bf16, 3.35 TB/s HBM3, 18 NVLink 4 links of 50 GB/s (900 GB/s in all),
# 80 GB, 67 TFLOP/s float32 outside the tensor cores.  Rates assume the
# card's full 700 W power limit.
H100 = HwSpec(
    name="h100-sxm5-80gb",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_link_bw=50e9,
    hbm_bytes=80e9,
)
