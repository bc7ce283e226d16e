"""Multiplicative (LFSR) descrambling as a GF(2) FIR convolution.

Port of ``pymodem_tpu.ops.lfsr``.  The reference descrambler
(lfsr.py:22-52) is a bit-serial loop; unrolled, its output is a feed-forward
XOR convolution of the input bit stream:

    out[n] = XOR_{j : poly bit j set} b[n - j]   XOR   bit n of the seed

so the whole stream descrambles as a handful of shifted XORs with no
sequential dependence.  Integer stage: bitwise equal to the JAX package.
The tensor functions import torch when called; the host half
(``np_descramble_bytes``, ``poly_tap_positions``) serves the torch-free
host codecs and synthesizer.
"""

from __future__ import annotations

import numpy as np


def poly_tap_positions(polynomial: int) -> tuple[int, ...]:
    """Bit positions set in the polynomial (delay of each XOR tap)."""
    return tuple(j for j in range(polynomial.bit_length()) if (polynomial >> j) & 1)


def _byte_shift_right(d: torch.Tensor, j: int) -> torch.Tensor:
    """The MSB-first bit stream of ``d`` (uint8, last axis) shifted right by
    j bits with zero fill, re-packed per byte: whole-byte shifts plus one
    sub-byte shift, no 8x bit expansion."""
    import torch
    import torch.nn.functional as F

    bs, rs = divmod(j, 8)
    n = d.shape[-1]

    def zshift(k):
        if k == 0:
            return d
        if k >= n:
            return torch.zeros_like(d)
        return F.pad(d, (k, 0))[..., :n]

    if rs == 0:
        return zshift(bs)
    hi = zshift(bs + 1) << (8 - rs)  # uint8: wraps mod 256 like jnp.uint8
    lo = zshift(bs) >> rs
    return hi | lo


def _seed_bytes(seed: int, n_bytes: int) -> np.ndarray:
    """MSB-first packing of the seed's shift-out bits (bit i of the seed
    leaves the register at stream time i)."""
    n_bits = min(n_bytes * 8, seed.bit_length())
    bits = np.zeros(n_bytes * 8, dtype=np.uint8)
    for i in range(n_bits):
        bits[i] = (seed >> i) & 1
    return np.packbits(bits)


def descramble_bytes(data: torch.Tensor, polynomial: int,
                     invert: bool = False, seed: int = 0) -> torch.Tensor:
    """Descramble a uint8 byte stream along its last axis (free-running
    across the whole stream), as LFSR.stream_unscramble_8bit
    (lfsr.py:22-52): MSB-first bit order, shift register initialised to
    ``seed`` (0x1F0 for IL2P block unscrambling, il2p.py:161), optional
    output invert."""
    import torch

    from ..device import upload

    d = data.to(torch.uint8)
    out = torch.zeros_like(d)
    for j in poly_tap_positions(polynomial):
        out = out ^ _byte_shift_right(d, j)
    if seed:
        n = d.shape[-1]
        pad = np.zeros(n, dtype=np.uint8)
        sb = _seed_bytes(seed, n)
        pad[: sb.shape[0]] = sb
        out = out ^ upload(pad, d.device)
    if invert:
        out = out ^ 0xFF
    return out


def descramble_bytes_multi(data: torch.Tensor, polys: tuple[int, ...],
                           inverts: tuple[bool, ...]) -> torch.Tensor:
    """Per-chain descramble over a stacked (C, ..., K) byte stream.

    Each chain's polynomial and output invert apply as per-chain XOR masks,
    so chains differing only in (poly, invert) share one bank (the
    reference's main program mixes them freely, pymodem.py:140-166).
    Polynomial 0 (no stream stage) acts as the identity, like poly 0x1.  A
    tap set by every chain skips its mask.
    """
    eff = tuple((p if p else 1) for p in polys)
    if all(p == 1 for p in eff) and not any(inverts):
        return data
    import torch

    from ..device import upload

    d = data.to(torch.uint8)
    extra = (1,) * (d.ndim - 1)

    def sel(mask_np: np.ndarray) -> torch.Tensor:
        return upload(mask_np, d.device).reshape((-1,) + extra)

    taps = sorted({j for p in eff for j in poly_tap_positions(p)})
    out = torch.zeros_like(d)
    for j in taps:
        mask = np.array([0xFF if (p >> j) & 1 else 0 for p in eff], np.uint8)
        term = _byte_shift_right(d, j)
        out = out ^ (term if mask.all() else (term & sel(mask)))
    inv = np.array([0xFF if v else 0 for v in inverts], np.uint8)
    if inv.all():
        out = out ^ 0xFF
    elif inv.any():
        out = out ^ sel(inv)
    return out


def np_descramble_bytes(data: np.ndarray, polynomial: int, invert: bool = False,
                        seed: int = 0) -> np.ndarray:
    """Host-side descrambler (vectorized numpy) for the host codec paths,
    matching LFSR.stream_unscramble_8bit (lfsr.py:22-52): MSB-first bit
    order, shift register initialized to ``seed``, optional output invert."""
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
