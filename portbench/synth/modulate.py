# Frozen copy of pymodem_tpu_torch/synth/modulate.py at commit 0117b87.
# The benchmark keeps its own copy so that later changes to the port
# do not move the yardstick; do not edit it to follow the port.
"""Transmit-side modulators (test-fixture generators).

Maps bit/symbol streams onto audio that the decode chains lock to.  Defined
by round-trip: modulate -> demod chain -> identical packets
(tests/test_synth.py).  Symbol mappings mirror the slicers' decision tables
(slicer.py): binary slicer reads sign, quadrature slicer reads differential
sign pairs through its demap, four-level slicer reads amplitudes vs a
sync-armed threshold.

The port's copy of ``pymodem_tpu.synth.modulate``; the tests hold the two to
the same audio, sample for sample.
"""

from __future__ import annotations

import numpy as np

# quadrature slicer demap (slicer.py:203-224): index = prev(2b)<<2 | cur(2b)
_QPSK_DEMAP = (3, 1, 2, 0, 2, 3, 0, 1, 1, 0, 3, 2, 0, 2, 1, 3)
# inverse: (prev_state, dibit) -> current_state
_QPSK_ENC = {}
for idx, out in enumerate(_QPSK_DEMAP):
    _QPSK_ENC[(idx >> 2, out)] = idx & 0x3


def _bit_wave(bits, sample_rate: float, bit_rate: float) -> np.ndarray:
    """Per-sample bit index stream (handles non-integer samples/bit)."""
    n = int(round(len(bits) * sample_rate / bit_rate))
    idx = np.minimum((np.arange(n) * bit_rate / sample_rate).astype(np.int64),
                     len(bits) - 1)
    return np.asarray(bits, dtype=np.float64)[idx]


def afsk_modulate(bits, sample_rate: float, bit_rate: float,
                  mark_freq: float, space_freq: float,
                  amplitude: float = 10000.0) -> np.ndarray:
    """Phase-continuous AFSK: bit 1 -> mark tone, bit 0 -> space tone."""
    wave = _bit_wave(bits, sample_rate, bit_rate)
    freq = np.where(wave > 0.5, mark_freq, space_freq)
    phase = 2.0 * np.pi * np.cumsum(freq) / sample_rate
    return amplitude * np.sin(phase)


def fsk_modulate(bits, sample_rate: float, bit_rate: float,
                 amplitude: float = 10000.0) -> np.ndarray:
    """Baseband NRZ pulses: bit 1 -> +A, bit 0 -> -A (fsk.py input)."""
    wave = _bit_wave(bits, sample_rate, bit_rate)
    return amplitude * (2.0 * wave - 1.0)


def four_level_modulate(dibits, sample_rate: float, symbol_rate: float,
                        amplitude: float = 10000.0,
                        preamble_symbols: int = 64) -> np.ndarray:
    """4FSK baseband: dibit -> level via the slicer's demap inverse
    (slicer.py:270 symbol_map [1, 3, -1, -3] -> demap [2, 0, 3, 1]).

    The four-level slicer only arms its decision threshold after seeing the
    0x5555/0xCCCC sync pattern in its sign register (slicer.py:380-389), so
    a +3/-3 alternating preamble is prepended.
    """
    # slicer decisions (ops/slicers.py four_level_slice): +big -> symbol 3,
    # +small -> 2, -small -> 1, -big -> 0; dibit = demap[symbol] with
    # demap (2, 0, 3, 1).  Inverse:
    level_of_dibit = {1: 3.0, 3: 1.0, 0: -1.0, 2: -3.0}
    symbols = [3.0 if i % 2 == 0 else -3.0 for i in range(preamble_symbols)]
    symbols += [level_of_dibit[int(d)] for d in dibits]
    wave = _bit_wave(symbols, sample_rate, symbol_rate)
    # _bit_wave interpolates indices; map through the symbol list directly
    n = int(round(len(symbols) * sample_rate / symbol_rate))
    idx = np.minimum((np.arange(n) * symbol_rate / sample_rate).astype(np.int64),
                     len(symbols) - 1)
    return amplitude / 3.0 * np.asarray(symbols, dtype=np.float64)[idx]


def bpsk_modulate(bits, sample_rate: float, symbol_rate: float,
                  carrier_freq: float, amplitude: float = 10000.0,
                  preamble_symbols: int = 48) -> np.ndarray:
    """BPSK on a carrier: bit -> +-1 on the in-phase rail.

    A +1/-1 alternating preamble gives the Costas loop and the slicer's
    timing recovery transitions to lock to.
    """
    symbols = [1.0 if i % 2 == 0 else -1.0 for i in range(preamble_symbols)]
    symbols += [1.0 if b else -1.0 for b in bits]
    n = int(round(len(symbols) * sample_rate / symbol_rate))
    idx = np.minimum((np.arange(n) * symbol_rate / sample_rate).astype(np.int64),
                     len(symbols) - 1)
    rail = np.asarray(symbols, dtype=np.float64)[idx]
    t = np.arange(n) / sample_rate
    return amplitude * rail * np.cos(2.0 * np.pi * carrier_freq * t)


def qpsk_symbols_from_bits(bits, initial_state: int = 0) -> list[int]:
    """Differentially encode dibits into quadrature-slicer symbol states.

    The slicer emits demap[prev<<2 | cur] (slicer.py:203-224), so each
    transmitted state is chosen to make the demap output equal the wanted
    dibit given the previous state.
    """
    if len(bits) % 2:
        bits = list(bits) + [0]
    state = initial_state
    out = []
    for i in range(0, len(bits), 2):
        dibit = (bits[i] << 1) | bits[i + 1]
        state = _QPSK_ENC[(state, dibit)]
        out.append(state)
    return out


def qpsk_modulate(bits, sample_rate: float, symbol_rate: float,
                  carrier_freq: float, amplitude: float = 10000.0,
                  preamble_symbols: int = 48) -> np.ndarray:
    """QPSK on a carrier; symbol state bit1 -> I sign, bit0 -> Q sign.

    The preamble alternates diagonal states (I,Q = ++, --) for timing
    transitions on both rails.
    """
    states = [3 if i % 2 == 0 else 0 for i in range(preamble_symbols)]
    start = states[-1]
    data_states = qpsk_symbols_from_bits(bits, initial_state=start)
    states += data_states
    n = int(round(len(states) * sample_rate / symbol_rate))
    idx = np.minimum((np.arange(n) * symbol_rate / sample_rate).astype(np.int64),
                     len(states) - 1)
    sv = np.asarray(states, dtype=np.int64)[idx]
    i_rail = np.where((sv & 2) != 0, 1.0, -1.0)
    q_rail = np.where((sv & 1) != 0, 1.0, -1.0)
    t = np.arange(n) / sample_rate
    w = 2.0 * np.pi * carrier_freq * t
    # I on cos, Q on -sin: matches the demod's i_mixer = x*cos, q = x*(-sin)
    return amplitude * (i_rail * np.cos(w) - q_rail * np.sin(w)) / np.sqrt(2)


def awgn(signal: np.ndarray, snr_db: float, rng: np.random.Generator) -> np.ndarray:
    power = float(np.mean(signal**2))
    noise_power = power / (10.0 ** (snr_db / 10.0))
    return signal + rng.normal(0.0, np.sqrt(noise_power), len(signal))


def to_int16(signal: np.ndarray) -> np.ndarray:
    peak = np.abs(signal).max() or 1.0
    return np.clip(signal / peak * 20000.0, -32768, 32767).astype(np.int16)
