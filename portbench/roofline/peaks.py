"""Peak rates of the cards the benchmark runs on (NVIDIA's data sheets,
dense, at the card's full power limit: 700 W for the H100 SXM)."""

from __future__ import annotations

PEAKS = {
    # H100 SXM5 80 GB: HBM3 at 3.35 TB/s
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, key: str) -> float | None:
    """The card's peak, or None for a card the table does not hold."""
    entry = PEAKS.get(device_name)
    return None if entry is None else entry[key]
