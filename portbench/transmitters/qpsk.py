"""QPSK on a carrier, two line bits a symbol, differentially encoded for
the quadrature slicer's demap, behind an alternating diagonal preamble."""

from __future__ import annotations

import numpy as np

from ..synth import modulate as mod


def modulate(tx: dict, line_bits: list[int], rate: float) -> np.ndarray:
    """(I cos - Q sin) / sqrt(2) with I, Q = +-1: mean power 1/2."""
    return mod.qpsk_modulate(line_bits, rate, tx["symbol_rate"],
                             tx["carrier_freq"], amplitude=1.0,
                             preamble_symbols=tx.get("preamble_symbols", 48))
