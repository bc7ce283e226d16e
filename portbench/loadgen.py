"""The one traffic generator: recordings from a configuration's
transmitter and a traffic mix file, made from the seed.

A recording is AWGN at a fixed noise floor with transmissions laid on it.
Each transmission is one frame of the configuration's codec, line-coded
and modulated as the configuration's ``transmitter`` says, at an amplitude
that gives it an SNR drawn for it (signal power over the noise power in
``snr_bandwidth_hz``).  Every seed draws the same set of payload sizes and
SNRs (evenly spread over the mix's ranges), in another order, and the same
number of frames, so that the seed changes where the work lies, not how
much of it there is.

Arrivals (``frames.<codec>.arrivals`` in the mix):

* ``poisson``: ``per_hour`` frames an hour, a fixed count per segment at
  uniform random times (a Poisson process given its count), apart.
* ``back_to_back``: each frame led by ``gap_bits`` of idle fill, one after
  the other with no silence between.
* ``load``: silence between transmissions so that the channel is busy
  ``load`` of the time; each gap is the mean gap times a uniform draw from
  [0.5, 1.5].

A segment of ``segment_seconds`` is tiled to ``seconds`` where the mix says
so; every recording is distinct.  Only numpy and the benchmark's frozen
copies of the synthesizer are used.

Transmitters are found by the configuration's ``transmitter.modulation``:
``transmitters/<modulation>.py`` holds one function, ``modulate(tx,
line_bits, rate)``, which turns the scrambled line bits of one
transmission into a float64 waveform at ``rate`` samples a second whose
mean power over the transmission is 1/2, the power of a sine of unit
amplitude.  The SNR drawn for a frame then sets the same signal power for
every family.  A new modem family is a new file there, not an edit here.
"""

from __future__ import annotations

import importlib
import math
from pathlib import Path

import numpy as np

from .synth import encode as enc

NOISE_RMS = 500.0
_ALPHABET = np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789 ,./:;!=",
    dtype=np.uint8)
_FLAG = [0, 1, 1, 1, 1, 1, 1, 0]
_CALLS = ("KI5ABC", "N0CALL", "W5XYZ", "K4QRP", "VE3ZZ", "G4TUV", "DL1ABC",
          "JA1XYZ")


def _spread(lo: float, hi: float, n: int) -> np.ndarray:
    """n values evenly over [lo, hi]."""
    if n == 1:
        return np.asarray([(lo + hi) / 2.0])
    return lo + (hi - lo) * np.arange(n) / (n - 1)


def _idle(n: int) -> list[int]:
    return [1 if i % 2 == 0 else 0 for i in range(n)]


def _frame_bits(tx: dict, payload: bytes, dest: str, source: str,
                lead_bits: int) -> list[int]:
    """Line bits of one transmission (before the scrambler)."""
    if tx["codec"] == "il2p":
        bits = _idle(lead_bits)
        bits += enc.bytes_to_bits_msb(enc.il2p_frame(dest, source, payload))
        return bits + _idle(tx["tail_bits"])
    # AX.25: opening flags, the frame, closing flags
    bits = enc.hdlc_encode(enc.ax25_ui_frame(dest, source, payload),
                           flag_count=max(lead_bits // 8, 1))
    return bits + _FLAG * tx["tail_flags"]


def transmitter(modulation: str):
    """The module of ``transmitters/<modulation>.py``."""
    path = Path(__file__).parent / "transmitters" / f"{modulation}.py"
    if not path.is_file():
        raise ValueError(f"no transmitter for modulation {modulation!r}: "
                         f"{path} does not exist")
    return importlib.import_module(f".transmitters.{modulation}", __package__)


def _modulate(tx: dict, bits: list[int], rate: float) -> np.ndarray:
    line = enc.scramble_bits(bits, int(tx["poly"], 16), bool(tx["invert"]))
    return transmitter(tx["modulation"]).modulate(tx, line, rate)


def _segment(tx: dict, mix: dict, rate: float, seconds: float,
             rng: np.random.Generator) -> tuple[np.ndarray, int]:
    """(float64 segment with its noise, frames sent)."""
    n = int(round(seconds * rate))
    out = rng.standard_normal(n) * NOISE_RMS
    spec = mix["frames"][tx["codec"]]
    lo, hi = spec["payload_bytes"]
    arrivals = spec["arrivals"]
    band_noise = NOISE_RMS ** 2 * mix["snr_bandwidth_hz"] / (rate / 2.0)

    def amplitude(snr_db: float) -> float:
        # a sine of amplitude A has power A^2 / 2
        return math.sqrt(2.0 * band_noise * 10.0 ** (snr_db / 10.0))

    def frame(i: int, size: int, lead: int) -> np.ndarray:
        payload = bytes(rng.choice(_ALPHABET, size=int(size)))
        dest, source = (_CALLS[(i + k) % len(_CALLS)] for k in (0, 1))
        return _modulate(tx, _frame_bits(tx, payload, dest, source, lead),
                         rate)

    if arrivals == "poisson":
        count = int(round(spec["per_hour"] * seconds / 3600.0))
        sizes = rng.permutation(np.rint(_spread(lo, hi, count)))
        snrs = rng.permutation(_spread(*mix["snr_db"], count))
        waves = [frame(i, s, tx["lead_bits"]) for i, s in enumerate(sizes)]
        total = sum(len(w) for w in waves)
        # uniform order statistics over the free time: the gaps of a
        # Poisson process given its count
        cuts = np.sort(rng.uniform(0.0, n - total, count))
        start = 0.0
        for w, snr, cut, prev in zip(waves, snrs, cuts,
                                     np.concatenate([[0.0], cuts[:-1]])):
            start += cut - prev
            s = int(start)
            out[s : s + len(w)] += amplitude(snr) * w
            start += len(w)
        return out, count
    # frames one after another until the segment is full: sizes and SNRs
    # cycle through fixed sets, each cycle in another order
    cycle = int(spec.get("cycle", 16))
    sizes_set = np.rint(_spread(lo, hi, cycle))
    snr_set = _spread(*mix["snr_db"], cycle)
    pos, i = 0, 0
    while True:
        if i % cycle == 0:
            sizes = rng.permutation(sizes_set)
            snrs = rng.permutation(snr_set)
        lead = spec.get("gap_bits", tx["lead_bits"])
        w = frame(i, sizes[i % cycle], lead)
        if arrivals == "load":
            gap = len(w) * (1.0 / spec["load"] - 1.0) * rng.uniform(0.5, 1.5)
        elif arrivals == "back_to_back":
            gap = 0.0
        else:
            raise ValueError(f"no arrivals {arrivals!r}")
        if pos + len(w) > n:
            return out, i
        out[pos : pos + len(w)] += amplitude(snrs[i % cycle]) * w
        pos += len(w) + int(gap)
        i += 1


def recordings(config: dict, mix: dict, seed: int
               ) -> tuple[list[np.ndarray], int]:
    """The mix's distinct int16 recordings for one configuration, and the
    frames sent in them."""
    rate = float(config["sample_rate"])
    tx = config["transmitter"]
    rng = np.random.default_rng(seed)
    seg_s = float(mix.get("segment_seconds", mix["seconds"]))
    reps = int(round(float(mix["seconds"]) / seg_s))
    recs, sent = [], 0
    for _ in range(int(mix["recordings"])):
        seg, count = _segment(tx, mix, rate, seg_s, rng)
        seg = np.clip(np.rint(seg), -32768, 32767).astype(np.int16)
        recs.append(np.tile(seg, reps) if reps > 1 else seg)
        sent += count * reps
    return recs, sent
