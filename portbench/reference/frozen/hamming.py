# Frozen copy of the JAX package's pymodem_tpu/ops/hamming.py at commit
# 0117b87; its jax imports and device functions left out. The benchmark's
# reference: it is not the port's code, and it is not edited to follow
# either package.
"""Hamming(7,4) decoding for the IL2P trailing CRC field.

IL2P protects each nibble of the trailing CRC-16 with a Hamming(7,4) code
(il2p.py:503-518 consumes four such bytes).  Hamming(7,4) is a perfect code,
so the 128-entry decode table is fully determined by the 16 codewords below
(IL2P protocol constants): every 7-bit word is within distance one of exactly
one codeword and decodes to that codeword's nibble.
"""

from __future__ import annotations

import numpy as np

# IL2P Hamming(7,4) codewords, indexed by data nibble (protocol constant).
HAMMING74_CODEWORDS = (
    0x00, 0x71, 0x62, 0x13, 0x54, 0x25, 0x36, 0x47,
    0x38, 0x49, 0x5A, 0x2B, 0x6C, 0x1D, 0x0E, 0x7F,
)


def _build_decode_table() -> np.ndarray:
    table = np.zeros(128, dtype=np.uint8)
    for nibble, word in enumerate(HAMMING74_CODEWORDS):
        table[word] = nibble
        for bit in range(7):
            table[word ^ (1 << bit)] = nibble
    return table


HAMMING74_DECODE = _build_decode_table()


def hamming74_decode(byte: int) -> int:
    """Decode a 7-bit received word (high bit ignored) to its data nibble."""
    return int(HAMMING74_DECODE[int(byte) & 0x7F])
