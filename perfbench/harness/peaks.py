"""Published peaks of the cards a cell may run on.

NVIDIA's data sheet for the H100 SXM part, dense rates, at its full power
limit of 700 W (a card set below it runs slower; the result line carries
the card's limit beside the shares computed from these).
"""
from __future__ import annotations

PEAKS = {
    "H100": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_for(device_name: str) -> dict:
    """The table's row whose key names the card, or a ValueError."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    raise ValueError(f"no published peaks for {device_name!r}")
