"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet for the H100 SXM part, dense rates, at its 700 W limit)."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict:
    """The row of `device_name`; a card not in the table has none, and the
    metrics that need one are left out."""
    return PEAKS.get(device_name, {})


def least_seconds(ops: float, nbytes: float, device_name: str):
    """The least time the card needs for `ops` float32 operations and
    `nbytes` bytes of HBM traffic: the larger of the two quotients, or
    None for a card without peaks."""
    p = peaks(device_name)
    if not p:
        return None
    return max(ops / p["float32_flops"], nbytes / p["hbm_bytes_per_s"])
