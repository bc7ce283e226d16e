# Frozen copy of the JAX package's pymodem_tpu/ops/gf.py at commit
# 0117b87, only GFTables, make_gf, GF256, np_gf_mul, np_poly_mul; its jax
# imports and device functions left out. The benchmark's reference: it is
# not the port's code, and it is not edited to follow either package.
"""GF(2^m) arithmetic via log/antilog tables.

The reference builds its field tables with a downward-stepping Galois LFSR
(gf_functions.py:47-66); that construction is exactly the standard antilog
table for the field generated by x over the given primitive polynomial
(verified equal element-for-element for GF(256)/0x11D), so we build it the
standard way.  Two behavioural quirks of the reference are preserved because
the Reed-Solomon decoder depends on them:

* ``log[0] == 0`` (the index array entry for 0 is never written,
  gf_functions.py:55-66); the Forney step reads it when the error-evaluator
  derivative is zero (rs_functions.py:131-136).
* index reductions are mod (order-1) over non-negative inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class GFTables:
    order: int  # field size, 2**m
    antilog: np.ndarray  # (order-1,) alpha**i
    log: np.ndarray  # (order,)  log of each element; log[0] == 0
    inverse: np.ndarray  # (order,)  multiplicative inverse; inverse[0] == 0


def make_gf(power: int, genpoly: int) -> GFTables:
    order = 1 << power
    high_bit = 1 << power
    antilog = np.zeros(order - 1, dtype=np.int32)
    log = np.zeros(order, dtype=np.int32)
    v = 1
    for i in range(order - 1):
        antilog[i] = v
        log[v] = i
        v <<= 1
        if v & high_bit:
            v ^= genpoly
    log[0] = 0  # reference quirk (never written), see module docstring
    inverse = np.zeros(order, dtype=np.int32)
    nz = np.arange(1, order)
    inverse[nz] = antilog[(order - 1 - log[nz]) % (order - 1)]
    return GFTables(order=order, antilog=antilog, log=log, inverse=inverse)


GF256 = make_gf(8, 0x11D)  # the field both IL2P RS codes use (il2p.py:133-134)


def np_gf_mul(gf: GFTables, a, b):
    """Elementwise GF multiply on numpy int arrays."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    prod = gf.antilog[(gf.log[a] + gf.log[b]) % (gf.order - 1)]
    return np.where((a == 0) | (b == 0), 0, prod)


def np_poly_mul(gf: GFTables, p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """GF polynomial product (XOR-accumulated), lowest order first."""
    out = np.zeros(len(p) + len(q) - 1, dtype=np.int32)
    for i, pi in enumerate(p):
        out[i : i + len(q)] ^= np_gf_mul(gf, pi, q)
    return out


