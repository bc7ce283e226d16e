"""The binary timing slicer (upstream slicer.py:59-107)."""

from __future__ import annotations


def slice(spec, baseband, arith) -> tuple[list, list]:
    """(bytes, 1-based sample addresses) of each completed byte."""
    q = arith.q
    sps = spec.sample_rate / spec.symbol_rate
    lock_rate = spec.lock_rate
    rollover = sps / 2.0 - 0.5
    clock, byte, bits, last = 0.0, 0, 0, 0.0
    data, addr = [], []
    for t, v in enumerate(baseband.tolist()):
        clock = q(clock + 1.0)
        if clock >= rollover:
            clock = q(clock - sps)
            byte = ((byte << 1) & 0xFF) | (v >= 0.0)
            bits += 1
            if bits >= 8:
                bits = 0
                data.append(byte)
                addr.append(t + 1)
        if (last < 0.0) != (v < 0.0):
            clock = q(clock * lock_rate)
        last = v
    return data, addr
