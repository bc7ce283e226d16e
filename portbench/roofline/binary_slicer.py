"""Byte count of kernel K1, the binary timing slicer
(``pymodem_tpu_torch/csrc/binary_slicer.cu``), from the traffic alone.

Per chain, K1 needs the chain's baseband read once (a float32 a sample)
and its emission code stream written once: one int32 code per emission
window of ``w`` samples, where ``w`` is the largest power-of-two window
that holds at most one byte decision at the chain's symbol period and lock
rate (the rule of ``ops/slicers.safe_compact_window``, frozen at commit
0117b87).  Block overlap, lane padding and parameter rows are not counted,
so the count does not move when the block plan does."""

from __future__ import annotations

KERNEL = "binary_slice_kernel"


def safe_compact_window(samples_per_symbol: float, lock_rate: float,
                        bits_per_symbol: int) -> int:
    spacing = (8.0 / bits_per_symbol) * samples_per_symbol * lock_rate
    w = 1
    while w * 2 <= max(spacing * 0.45, 1.0):
        w *= 2
    return min(w, 256)


def bytes_needed(chains: list, n_samples: int) -> float:
    """Bytes K1 must move to slice ``n_samples`` samples of every chain
    (``chains``: the reference's chain specs)."""
    total = 0.0
    for c in chains:
        sl = c.slicer
        w = safe_compact_window(sl.sample_rate / sl.symbol_rate,
                                sl.lock_rate, 1)
        total += 4.0 * n_samples + 4.0 * n_samples / w
    return total
