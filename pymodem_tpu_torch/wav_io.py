"""Audio ingest/egress (host): the port's copy of ``pymodem_tpu.wav_io``."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """Returns (sample_rate, samples); int16 mono, like pymodem.py:46."""
    rate, data = wavfile.read(path)
    return int(rate), np.asarray(data)


def write_wav(path: str, rate: int, data: np.ndarray) -> None:
    wavfile.write(path, int(rate), np.asarray(data))
