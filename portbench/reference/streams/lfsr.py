"""The multiplicative LFSR descrambler (upstream lfsr.py)."""

from __future__ import annotations

from ..frozen.lfsr import np_descramble_bytes


def apply(spec, raw):
    return np_descramble_bytes(raw, spec.polynomial, spec.invert)
