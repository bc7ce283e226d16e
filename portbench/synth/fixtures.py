# Frozen copy of pymodem_tpu_torch/synth/fixtures.py at commit 0117b87, without ax25_edge_rows (torch or unused).
# The benchmark keeps its own copy so that later changes to the port
# do not move the yardstick; do not edit it to follow the port.
"""Synthetic IL2P and AX.25 fixtures for every modem family, jax-free.

Port of ``pymodem_tpu.synth.fixtures``: modulated frames matched to a
chain spec (AFSK, AFSK-PLL, BPSK, Costas QPSK, MPSK, FSK and 4FSK, either
codec), for tests and for
``chip_smoke.py`` on a machine without JAX.  Modulation goes through the
port's copy of ``synth/modulate.py``.  The round trip
decode(modulate(frames)) == frames is what the tests assert.
"""

from __future__ import annotations

import numpy as np

from . import encode as enc
from . import modulate as mod


def _idle_bits(n: int) -> list[int]:
    return [1 if i % 2 == 0 else 0 for i in range(n)]


def il2p_line_bits(payloads, polynomial: int = 0x3, invert: bool = False,
                   gap_bits: int = 400, dest: str = "KI5ABC",
                   source: str = "N0CALL") -> list[int]:
    """Concatenated IL2P frames with alternating idle fill, scrambled into
    line bits as ONE free-running stream (the decoder's descrambler is
    free-running too, lfsr.py:22-51)."""
    bits: list[int] = []
    for payload in payloads:
        frame = enc.il2p_frame(dest, source, payload)
        bits += _idle_bits(gap_bits)
        bits += enc.bytes_to_bits_msb(frame)
    bits += _idle_bits(gap_bits)
    return enc.scramble_bits(bits, polynomial, invert)


def ax25_line_bits(frames_payloads, polynomial: int = 0x3, invert: bool = True,
                   gap_bits: int = 400, dest: str = "KI5ABC",
                   source: str = "N0CALL") -> list[int]:
    """Concatenated AX.25/HDLC frames, NRZI(+scramble)-encoded line bits."""
    bits: list[int] = []
    for payload in frames_payloads:
        frame = enc.ax25_ui_frame(dest, source, payload)
        bits += _idle_bits(gap_bits)
        bits += enc.hdlc_encode(frame, flag_count=8)
    bits += _idle_bits(gap_bits)
    return enc.scramble_bits(bits, polynomial, invert)


def payloads(rng: np.random.Generator, count: int = 3,
             size: int = 40) -> list[bytes]:
    """ASCII payloads (printable-header safe)."""
    alphabet = np.frombuffer(
        b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789 ",
        dtype=np.uint8,
    )
    return [
        bytes(rng.choice(alphabet, size=size)) for _ in range(count)
    ]


def synthesize_for_chain(chain, rate: float, rng: np.random.Generator,
                         n_frames: int = 3, size: int = 30,
                         gap_bits: int = 600):
    """Audio carrying ``n_frames`` frames, line-coded per the chain's own
    spec (codec family, scrambler poly/invert, modem tones, carrier and
    rates).  Returns (sent_payloads, audio_float)."""
    poly = chain.stream.polynomial if chain.stream else 0x1
    invert = bool(chain.stream.invert) if chain.stream else False
    sent = payloads(rng, count=n_frames, size=size)
    if chain.codec.kind == "ax25":
        line = ax25_line_bits(sent, polynomial=poly, invert=invert,
                              gap_bits=gap_bits)
    else:
        line = il2p_line_bits(sent, polynomial=poly, invert=invert,
                              gap_bits=gap_bits)
    modem = chain.modem
    if modem.kind == "afsk":
        return sent, mod.afsk_modulate(line, rate, modem.symbol_rate,
                                       modem.mark_freq, modem.space_freq)
    if modem.kind == "afsk_pll":
        return sent, mod.afsk_modulate(line, rate, modem.symbol_rate,
                                       modem.carrier_freq - 5.0,
                                       modem.carrier_freq + 5.0)
    if modem.kind == "bpsk" or getattr(modem, "constellation", "") == "bpsk":
        return sent, mod.bpsk_modulate(line, rate, modem.symbol_rate,
                                       modem.carrier_freq)
    if modem.kind in ("qpsk", "mpsk"):
        return sent, mod.qpsk_modulate(line, rate, modem.symbol_rate,
                                       modem.carrier_freq)
    if modem.kind == "fsk":
        if chain.slicer.kind == "4level":
            dibits = [(a << 1) | b for a, b in zip(line[::2], line[1::2])]
            return sent, mod.four_level_modulate(dibits, rate,
                                                 chain.slicer.symbol_rate)
        return sent, mod.fsk_modulate(line, rate, modem.symbol_rate)
    raise ValueError(f"no fixture for modem {modem.kind!r}")


_FLAG = [0, 1, 1, 1, 1, 1, 1, 0]


