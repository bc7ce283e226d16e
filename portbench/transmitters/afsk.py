"""AFSK: phase-continuous mark and space tones at the bit rate."""

from __future__ import annotations

import numpy as np

from ..synth import modulate as mod


def modulate(tx: dict, line_bits: list[int], rate: float) -> np.ndarray:
    """A sine of unit amplitude: mean power 1/2."""
    return mod.afsk_modulate(line_bits, rate, tx["bit_rate"], tx["mark_freq"],
                             tx["space_freq"], amplitude=1.0)
