"""roofline — the card's data-sheet constants (`hw.H100`).

The reference's HLO cost model and hill-climbing (``repro/roofline``) read
compiled XLA artifacts of a TPU and are not ported (ROADMAP queue 1 item
24).
"""

from repro_torch.roofline.hw import H100, HwSpec

__all__ = ["H100", "HwSpec"]
