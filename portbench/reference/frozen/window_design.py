# Frozen copy of the JAX package's pymodem_tpu/dsp/window_design.py at
# commit 0117b87; its jax imports and device functions left out. The
# benchmark's reference: it is not the port's code, and it is not edited
# to follow either package.
"""Design-time filter/table synthesis (host-side numpy, float64).

Everything here runs once per chain at build time and produces static numpy
arrays that the JAX runtime closes over.  Numeric conventions deliberately
match the reference so that decode decisions agree bit-for-bit:

* FIR band/low-pass taps come from scipy.signal.firwin with the same argument
  shapes the reference uses (afsk.py:112-126, psk.py:118-124, fsk.py:133-138).
* RRC taps reproduce the reference's closed form including its time-grid
  construction, asymptote handling, L2 normalization and window handling
  (rrc.py:18-96) -- note the reference divides the generic-case numerator by
  ``denominator * symbol_time`` (rrc.py:43), which we reproduce as-is.
* Hilbert taps reproduce hilbert.py:9-34 (odd 2/(pi n) taps, hann window).
* The NCO wavetable is amplitude*sin(2 pi i / N) (nco.py:22-24).
* The MPSK phase-detector table is the quantized-atan2 table of
  phase_detector.py:37-45.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import firwin


def bandpass_taps(tap_count: int, low: float, high: float, fs: float,
                  scale: bool = False) -> np.ndarray:
    """Hamming-windowed band-pass FIR taps.

    The AFSK correlator modem omits scale (afsk.py:112-117, scipy default is
    scale=True anyway); the PSK/PLL modems pass scale=True explicitly
    (psk.py:118-124, afsk_pll.py:92-98).  Both produce identical taps, but we
    keep the flag for clarity.
    """
    return np.asarray(
        firwin(int(tap_count), [low, high], pass_zero="bandpass", fs=fs, scale=scale
               if scale else True),
        dtype=np.float64,
    )


def lowpass_taps(tap_count: int, cutoff: float, fs: float) -> np.ndarray:
    """Hamming-windowed low-pass FIR taps (afsk.py:122-126, fsk.py:133-138)."""
    return np.asarray(firwin(int(tap_count), cutoff, fs=fs), dtype=np.float64)


def tone_correlators(sample_rate: float, symbol_rate: float, span: float,
                     mark_freq: float, space_freq: float, space_gain: float,
                     offset: float) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Quadrature mark/space tone templates for the AFSK correlator.

    One symbol-span of cos/sin at each tone frequency, with the space pair
    scaled by space_gain (afsk.py:128-144).
    """
    n = math.ceil(span * sample_rate / symbol_rate)
    t = np.arange(n, dtype=np.float64)
    mark_phase = t * (2.0 * np.pi * (mark_freq + offset) / sample_rate)
    space_phase = t * (2.0 * np.pi * (space_freq + offset) / sample_rate)
    return (
        np.cos(mark_phase),
        np.sin(mark_phase),
        space_gain * np.cos(space_phase),
        space_gain * np.sin(space_phase),
    )


def rrc_taps(sample_rate: float, symbol_rate: float, symbol_span: float,
             rolloff_rate: float, window: str = "rect") -> np.ndarray:
    """Root-raised-cosine taps matching the reference designer (rrc.py:18-50).

    Only the 'rect' (no-op) window is exercised by the bundled configs; the
    other windows of rrc.py:51-93 are available via ``window_taps``.
    """
    oversample = sample_rate / symbol_rate
    tap_count = int(round(symbol_span * oversample, 0)) + 1
    dt = 1.0 / sample_rate
    ts = 1.0 / symbol_rate
    # The reference builds the grid with float arange and re-derives tap_count
    # from its length (rrc.py:23-24); replicate to keep any fp edge cases.
    time = np.arange(0, tap_count * dt, dt) - (tap_count * dt / 2) + (dt / 2)
    tap_count = len(time)

    taps = np.empty(tap_count, dtype=np.float64)
    if rolloff_rate != 0:
        asymptote = ts / (4.0 * rolloff_rate)
    else:
        asymptote = None
    for k, t in enumerate(time):
        if asymptote is not None and (
            math.isclose(t, -asymptote) or math.isclose(t, asymptote)
        ):
            num = rolloff_rate * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * rolloff_rate))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * rolloff_rate))
            )
            taps[k] = num / (ts * math.sqrt(2.0))
        else:
            num = np.sin(np.pi * t * (1 - rolloff_rate) / ts) + (
                4 * rolloff_rate * t * np.cos(np.pi * t * (1 + rolloff_rate) / ts) / ts
            )
            den = np.pi * t * (1 - (4 * rolloff_rate * t / ts) ** 2) / ts
            with np.errstate(divide="ignore", invalid="ignore"):
                v = num / (den * ts)
            taps[k] = 0.0 if not np.isfinite(v) else v
    taps = taps / np.linalg.norm(taps)
    if window != "rect":
        taps = taps * window_taps(tap_count, window)
    return taps


def window_taps(tap_count: int, window: str) -> np.ndarray:
    """Window functions from rrc.py:51-93 (names and constants as shipped)."""
    n = np.arange(tap_count, dtype=np.float64)
    big_n = tap_count - 1
    if window == "hann":
        return np.sin(np.pi * n / big_n) ** 2
    if window == "rect":
        return np.ones(tap_count)
    if window == "blackmann":
        a = (0.355768, 0.487396, 0.144232, 0.012604)
    elif window == "blackmann-harris":
        a = (0.35875, 0.48829, 0.14128, 0.01168)
    elif window == "flattop":
        a = (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368)
    elif window == "tukey":
        alpha = 0.25
        out = np.ones(tap_count)
        edge = int(np.ceil(alpha * big_n / 2))
        ramp = 0.5 * (1 - np.cos(2 * np.pi * n[:edge] / (alpha * big_n)))
        out[:edge] = ramp
        out[tap_count - edge:] = ramp[::-1]
        return out
    else:
        raise ValueError(f"unknown window {window!r}")
    w = np.zeros(tap_count)
    for k, coef in enumerate(a):
        w += ((-1) ** k) * coef * np.cos(2 * np.pi * k * n / big_n)
    return w


def hilbert_taps(tap_count: int, window: str = "hann") -> np.ndarray:
    """Odd-length type-III Hilbert transformer taps (hilbert.py:9-30)."""
    delay = tap_count // 2
    n = np.arange(-delay, -delay + tap_count, dtype=np.float64)
    taps = np.where(np.mod(n, 2) != 0, 2.0 / (np.pi * np.where(n == 0, 1, n)), 0.0)
    if window == "hann":
        big_n = tap_count - 1
        idx = np.arange(tap_count, dtype=np.float64)
        taps = taps * np.sin(np.pi * idx / big_n) ** 2
    return taps


def nco_wavetable(size: int, amplitude: float) -> np.ndarray:
    """Quantized sine wavetable (nco.py:22-24)."""
    i = np.arange(size, dtype=np.float64)
    return amplitude * np.sin(i * 2.0 * np.pi / size)


def iir1_lpf_coefs(sample_rate: float, cutoff: float, gain: float) -> tuple[float, float]:
    """First-order bilinear LPF: returns (b0, a1) with b1 == b0 (iir.py:17-30).

    y[n] = b0*x[n] + b0*x[n-1] + a1*y[n-1], with the gain folded into b0.
    """
    warp = 2.0 * sample_rate * math.tan(2.0 * math.pi * cutoff / (2.0 * sample_rate))
    omega_t = warp / sample_rate
    a1 = (2.0 - omega_t) / (2.0 + omega_t)
    b0 = gain * omega_t / (2.0 + omega_t)
    return b0, a1


def qpsk_error_table(granularity: int, gain: float) -> np.ndarray:
    """Quantized QPSK phase-error table (phase_detector.py:37-45).

    Entry [r][i] is round(gain * (atan2(i, r) deg - 45)) when the vector
    magnitude lies in [0.15, 0.76]*granularity, else 0.  Stored int32.
    """
    r = np.arange(granularity, dtype=np.float64)[:, None]
    i = np.arange(granularity, dtype=np.float64)[None, :]
    mag = np.sqrt(r ** 2 + i ** 2)
    ang = gain * (np.degrees(np.arctan2(i, r)) - 45.0)
    gate = (mag >= 0.15 * granularity) & (mag <= 0.76 * granularity)
    # Python's round() is round-half-to-even, same as np.round.
    return np.where(gate, np.round(ang), 0.0).astype(np.int32)
