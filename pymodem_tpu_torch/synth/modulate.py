"""Line-bit modulators, as ``pymodem_tpu.synth.modulate`` (numpy, no JAX).

The AFSK modulator and the int16 conversion are taken as they are, so the
port's fixtures synthesise the same audio sample for sample.
"""

from pymodem_tpu.synth.modulate import afsk_modulate, to_int16

__all__ = ["afsk_modulate", "to_int16"]
