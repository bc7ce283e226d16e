# Frozen copy of the JAX package's pymodem_tpu/ops/lfsr.py at commit
# 0117b87, only poly_tap_positions, np_descramble_bytes; its jax imports
# and device functions left out. The benchmark's reference: it is not the
# port's code, and it is not edited to follow either package.
"""Multiplicative (LFSR) descrambling as a GF(2) FIR convolution.

The reference descrambler (lfsr.py:22-52) is a bit-serial loop: for each
input bit b[n] (MSB first), XOR the polynomial into a shift register when
b[n] = 1, output the register's LSB, then shift right.  Unrolling that
recurrence shows the output is a *feed-forward* XOR convolution:

    out[n] = XOR_{j : poly bit j set} b[n - j]   XOR   bit n of the initial
                                                        shift register value

because the polynomial bit at position j, injected at time n, reaches the
LSB exactly j shifts later, and the seed's bit n shifts out at time n.
There is no sequential dependence at all -- the whole stream descrambles as
a handful of shifted XORs, which is the TPU-native formulation (pure VPU,
no scan).  This also makes time-block sharding trivial: the only halo is
``highest set bit of poly`` bits of the previous block.

Verified bit-exact against the reference implementation in
tests/test_primitives.py.
"""

from __future__ import annotations

import numpy as np

def poly_tap_positions(polynomial: int) -> tuple[int, ...]:
    """Bit positions set in the polynomial (delay of each XOR tap)."""
    return tuple(j for j in range(polynomial.bit_length()) if (polynomial >> j) & 1)


def np_descramble_bytes(data: np.ndarray, polynomial: int, invert: bool = False,
                        seed: int = 0) -> np.ndarray:
    """Host-side mirror (vectorized numpy) for tests and host codec paths."""
    bits = np.unpackbits(np.asarray(data, dtype=np.uint8))
    out = np.zeros_like(bits)
    for j in poly_tap_positions(polynomial):
        if j == 0:
            out ^= bits
        elif j < len(bits):
            out[j:] ^= bits[:-j]
    for i in range(min(len(bits), seed.bit_length())):
        out[i] ^= (seed >> i) & 1
    packed = np.packbits(out)
    if invert:
        packed ^= np.uint8(0xFF)
    return packed
