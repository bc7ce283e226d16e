# Frozen copy of the JAX package's pymodem_tpu/ops/rs.py at commit
# 0117b87, only RSCode, make_rs, RS_HEADER, RS_BLOCK, _np_syndromes,
# rs_decode_np, rs_encode_np; its jax imports and device functions left
# out. The benchmark's reference: it is not the port's code, and it is not
# edited to follow either package.
"""Reed-Solomon decode (and encode, for the signal synthesizer).

IL2P uses two RS codes over GF(256)/0x11D, first root 0: a (15,13) header
code (2 roots) and a (N,N-16) payload-block code (16 roots) (il2p.py:130-136).

``rs_decode_np`` reproduces the reference decoder's exact behaviour
(rs_functions.py:33-150): Horner syndromes, a Berlekamp iteration with a
persistent (stale-carrying) next-locator buffer, Chien search over the block,
Forney magnitudes with the reference's index arithmetic quirks (log[0] == 0;
index reductions that may pass through -1, which aliases to table[254]), a
``min_distance`` margin that refuses corrections when error_count exceeds
(nroots/2 - min_distance), and a final syndrome recheck that returns -1 on
failure while leaving any corrections applied.

``rs_decode_jax`` is the same algorithm in fixed-shape, batched array form:
everything is vectorized over a batch of blocks, loops are unrolled to the
static root count, and data-dependent sizes become masks.  Equivalence to the
numpy version (and transitively to the reference) is asserted in
tests/test_primitives.py over randomized error patterns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gf import GF256, GFTables, np_gf_mul, np_poly_mul


@dataclass(frozen=True)
class RSCode:
    gf: GFTables
    first_root: int
    num_roots: int
    genpoly: np.ndarray  # lowest order first, degree == num_roots


def make_rs(first_root: int, num_roots: int, gf: GFTables = GF256) -> RSCode:
    """Generator polynomial prod_{i}(x + alpha^(first_root+i))
    (rs_functions.py:9-31)."""
    genpoly = np.array([gf.antilog[first_root], 1], dtype=np.int32)
    for i in range(first_root + 1, first_root + num_roots):
        factor = np.array([gf.antilog[i], 1], dtype=np.int32)
        genpoly = np_poly_mul(gf, genpoly, factor)
    return RSCode(gf=gf, first_root=first_root, num_roots=num_roots, genpoly=genpoly)


RS_HEADER = make_rs(0, 2)  # il2p.py:131-135
RS_BLOCK = make_rs(0, 16)  # il2p.py:132-136


# ---------------------------------------------------------------------------
# Host (numpy) decoder -- exact mirror of the reference control flow
# ---------------------------------------------------------------------------


def _np_syndromes(rs: RSCode, data, block_size: int) -> np.ndarray:
    """Vectorized syndromes, identical to the reference's Horner loop
    (rs_functions.py:36-42): synd[i] = XOR_j d[j] * alpha^((fr+i)(bs-1-j))."""
    gf = rs.gf
    d = np.asarray(data[:block_size], dtype=np.int32)
    deg = np.arange(block_size - 1, -1, -1, dtype=np.int64)[:, None]  # (L, 1)
    roots = np.arange(rs.first_root, rs.first_root + rs.num_roots)[None, :]
    power = (deg * roots) % (gf.order - 1)  # (L, R)
    terms = np.where(
        d[:, None] == 0, 0, gf.antilog[(gf.log[d][:, None] + power) % (gf.order - 1)]
    )
    return np.bitwise_xor.reduce(terms, axis=0).astype(np.int32)


def rs_decode_np(rs: RSCode, data, block_size: int, min_distance: int = 0) -> int:
    """Decode in place; returns corrected-error count or -1 on failure."""
    gf = rs.gf
    order = gf.order
    nroots = rs.num_roots
    t2 = nroots // 2
    mul = lambda a, b: int(np_gf_mul(gf, a, b))

    synd = _np_syndromes(rs, data, block_size)

    # Berlekamp-Massey with the reference's buffer-reuse semantics.
    locator = np.zeros(nroots, dtype=np.int64)
    locator[0] = 1
    corrector = np.zeros(nroots + 1, dtype=np.int64)
    corrector[1] = 1
    next_locator = np.zeros(nroots, dtype=np.int64)  # persists across steps
    tracker = 0
    for step in range(1, nroots + 1):
        y = step - 1
        e = int(synd[y])
        for i in range(1, tracker + 1):
            e ^= mul(int(locator[i]), int(synd[y - i]))
        if e != 0:
            for i in range(tracker + 1):
                next_locator[i] = int(locator[i]) ^ mul(e, int(corrector[i]))
            e_inv = int(gf.inverse[e])
            for i in range(t2 + 1):
                corrector[i] = mul(int(locator[i]), e_inv)
            locator[: t2 + 1] = next_locator[: t2 + 1]
        if 2 * tracker < step:
            tracker = step - tracker
        corrector[1:] = corrector[:-1]
        corrector[0] = 0

    # Chien search (vectorized; the reference's repeated subtract-by-255
    # index reduction equals mod 255 on these non-negative indices).
    y = (np.arange(block_size, dtype=np.int64) + order - block_size)[:, None]
    i_idx = np.arange(1, t2 + 1, dtype=np.int64)[None, :]
    loc_i = locator[1 : t2 + 1][None, :]
    z = (y * i_idx + gf.log[loc_i]) % (order - 1)
    chien = np.bitwise_xor.reduce(
        np.where(loc_i != 0, gf.antilog[z], 0), axis=1
    ) ^ int(locator[0])
    locations = np.flatnonzero(chien == 0).tolist()
    error_count = len(locations)

    if error_count <= t2 - min_distance:
        # Forney.
        omega = np.zeros(nroots + 1, dtype=np.int64)
        for i in range(error_count):
            omega[i] = int(synd[rs.first_root + i])
            for j in range(1, i + 1):
                omega[i] ^= mul(int(synd[rs.first_root + i - j]), int(locator[j]))
        for k in range(error_count):
            e = block_size - locations[k] - 1
            z = int(omega[0])
            for j in range(1, error_count):
                # reference's two-step fold computes alpha^(-e*j)
                x = (-(e * j)) % (order - 1)
                z ^= mul(int(omega[j]), int(gf.antilog[x]))
            z = mul(z, int(gf.antilog[e]))
            y = int(locator[1])
            for j in range(3, t2 + 1, 2):
                x = (-(e * (j - 1))) % (order - 1)
                y ^= mul(int(locator[j]), int(gf.antilog[x]))
            ly = int(gf.log[y])  # log[0] == 0 quirk preserved
            yidx = order - ly - 1
            if yidx == order - 1:
                yidx = 0
            y = int(gf.antilog[yidx])
            data[locations[k]] ^= mul(y, z)

    # Recheck: corrections stay applied even on failure.
    synd = _np_syndromes(rs, data, block_size)
    if np.any(synd != 0):
        return -1
    return error_count


def rs_encode_np(rs: RSCode, data: np.ndarray) -> np.ndarray:
    """Append num_roots parity bytes so every decode syndrome is zero.

    The decoder evaluates the block as a polynomial with data[0] as the
    highest-order coefficient, so parity is the remainder of
    d(x) * x^nroots mod genpoly(x), appended after the data.
    """
    gf = rs.gf
    nroots = rs.num_roots
    work = np.concatenate([np.asarray(data, dtype=np.int32), np.zeros(nroots, np.int32)])
    gp = rs.genpoly[::-1]  # highest order first; gp[0] == 1
    for i in range(len(data)):
        coef = int(work[i])
        if coef:
            work[i : i + nroots + 1] ^= np_gf_mul(gf, coef, gp)
    out = np.concatenate([np.asarray(data, dtype=np.int32), work[len(data):]])
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Device (jax) decoder -- batched, fixed shapes, mask-driven
# ---------------------------------------------------------------------------


