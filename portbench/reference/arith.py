"""The precisions a reference decode runs in.

``float64``: the reference.  The FIRs are ``numpy.convolve(x, taps,
"valid")`` in float64, the reference decoder's own form; the recurrences
(AGC, loops, slicer clocks) run as plain Python loops over Python floats.

``control``: the control of the check, the step below the configuration's
float32: the FIR operands rounded to TF32 (10 explicit mantissa bits, the
step below float32 with TF32 off) and every recurrence state rounded to
bfloat16 after each step.

``float32``: a witness, not used by the check: FIR operands and
recurrence states rounded to float32 (the port's precision, though not its
order of operations).
"""

from __future__ import annotations

import math
import struct

import numpy as np


def round_mantissa(a: np.ndarray, bits: int) -> np.ndarray:
    """Round to ``bits`` explicit mantissa bits, half to even."""
    m, e = np.frexp(np.asarray(a, np.float64))
    scale = float(1 << (bits + 1))
    return np.ldexp(np.round(m * scale) / scale, e)


def bf16(x: float) -> float:
    m, e = math.frexp(x)
    return math.ldexp(round(m * 256.0) / 256.0, e)


_F32 = struct.Struct("f")


def f32(x: float) -> float:
    return _F32.unpack(_F32.pack(x))[0]


class Arith:
    """``q`` rounds a recurrence state; ``operands`` rounds FIR operands."""

    def __init__(self, precision: str = "float64"):
        if precision not in ("float64", "control", "float32"):
            raise ValueError(precision)
        self.precision = precision
        self.q = {"float64": float, "control": bf16, "float32": f32}[precision]

    def operands(self, *arrays):
        if self.precision == "control":
            return tuple(round_mantissa(a, 10) for a in arrays)
        if self.precision == "float32":
            return tuple(np.asarray(a, np.float32).astype(np.float64)
                         for a in arrays)
        return arrays

    def fir(self, x: np.ndarray, taps: np.ndarray) -> np.ndarray:
        x, taps = self.operands(x, taps)
        y = np.convolve(x, taps, "valid")
        return self.operands(y)[0] if self.precision == "float32" else y
