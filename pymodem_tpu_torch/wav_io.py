"""WAV input and output, as ``pymodem_tpu.wav_io`` (scipy, no JAX)."""

from pymodem_tpu.wav_io import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
