# Frozen copy of the JAX package's pymodem_tpu/dsp/loops.py at commit
# 0117b87, only LoopParams; its jax imports and device functions left out;
# jax.Array annotations written as np.ndarray. The benchmark's reference:
# it is not the port's code, and it is not edited to follow either
# package.
"""Carrier-recovery loops (PLL / Costas) as `lax.scan` recurrences.

Each reference modem runs a per-sample Python feedback loop built from an NCO
(wavetable oscillator, nco.py:34-53), a 1st-order IIR loop filter
(iir.py:38-54) and a PI controller (pi_control.py:25-33).  Here each loop is a
single fused scan body with the full carry pytree; banks of chains vmap over
the scan so each step is one wide VPU op per state variable.

Floating-point ordering matters for decision parity, so the step functions
keep the reference's exact operation order:
* proportional term: (gain * p_rate) * x   (pi_control.py:26 evaluates
  left-to-right, so gain*p_rate can be pre-fused)
* integral term:     integral + gain * (i_rate * x)   (pi_control.py:27
  parenthesizes i_rate*x first, so gain must NOT be pre-fused here)
* IIR output:        (b0*x + b1*x_prev) + a1*y_prev   (iir.py:38-54)
* NCO phase wrap by repeated +-2pi, not fmod (nco.py:36-39).
"""

from __future__ import annotations

from typing import NamedTuple

class LoopParams(NamedTuple):
    """Static per-chain loop constants; array-valued so banks can stack them."""

    wavetable: np.ndarray  # (wavetable_size,) NCO sine table
    set_frequency: np.ndarray  # () carrier frequency in Hz
    phase_scale: np.ndarray  # () 2*pi/sample_rate (nco.py:31)
    index_scale: np.ndarray  # () wavetable_size/(2*pi) (nco.py:27)
    iir_b0: np.ndarray  # () loop LPF numerator (b1 == b0)
    iir_a1: np.ndarray  # () loop LPF denominator
    pi_gp: np.ndarray  # () gain * p_rate, pre-fused
    pi_gain: np.ndarray  # () gain (kept separate for the integral term)
    pi_i: np.ndarray  # () i_rate
    pi_limit: np.ndarray  # () integral saturation bound
    pi_integral0: np.ndarray  # () initial integral (psk.py:703 for mpsk)


