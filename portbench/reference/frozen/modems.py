# Frozen copy of the JAX package's pymodem_tpu/modems.py at commit
# 0117b87, only TWO_PI, _round_taps, AGCParams, _agc_params,
# _loop_params_host, AFSKParams, _resample_poly_taps, afsk_params,
# PLLParams, afsk_pll_params; its jax imports and device functions left
# out; relative imports pointed at this folder. The benchmark's reference:
# it is not the port's code, and it is not edited to follow either
# package.
"""Modem forward passes: audio -> baseband (or IQ) on device.

Each family is (params builder, demod function).  Params are numpy arrays
built once on host from the spec (tap design etc.); demod functions are pure
JAX and dtype-polymorphic (float64 for CPU parity runs, float32/bfloat16 on
TPU).  Stage structure per family mirrors the reference call stacks
(SURVEY.md section 3) while the execution strategy is TPU-native: bulk FIRs
as (FFT) convolutions, sequential loops as fused scans.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .config import (
    AFSKModemSpec,
    AFSKPLLModemSpec,
    AGCSpec,
    BPSKModemSpec,
    FSKModemSpec,
    MPSKModemSpec,
    QPSKModemSpec,
)
from . import window_design as wd
from .loops import LoopParams

TWO_PI = 2.0 * np.pi


def _round_taps(rate: float, span: float, per: float) -> int:
    """Tap count = round(rate * span / per) with Python banker's rounding,
    as used by every reference tune() (e.g. afsk.py:103-108)."""
    return round(rate * span / per)


class AGCParams(NamedTuple):
    scaled_attack: np.float64
    scaled_decay: np.float64
    sustain_time: np.float64
    sustain_increment: np.float64
    target: np.float64


def _agc_params(spec: AGCSpec, sample_rate: float) -> AGCParams:
    return AGCParams(
        np.float64(spec.attack_rate / sample_rate),
        np.float64(spec.decay_rate / sample_rate),
        np.float64(spec.sustain_time),
        np.float64(1.0 / sample_rate),
        np.float64(spec.target_amplitude),
    )


def _loop_params_host(spec, integral_init: float | None = None) -> LoopParams:
    """Numpy (host) variant of _loop_params, for bank stacking: one device
    transfer per stacked pytree instead of one per leaf."""
    b0, a1 = wd.iir1_lpf_coefs(spec.sample_rate, spec.loop_lpf_cutoff, 1.0)
    pi = spec.pi
    return LoopParams(
        wavetable=wd.nco_wavetable(256, 1.0),
        set_frequency=np.float64(spec.carrier_freq),
        phase_scale=np.float64(TWO_PI / spec.sample_rate),
        index_scale=np.float64(256.0 / TWO_PI),
        iir_b0=np.float64(b0),
        iir_a1=np.float64(a1),
        pi_gp=np.float64(pi.gain * pi.p),
        pi_gain=np.float64(pi.gain),
        pi_i=np.float64(pi.i),
        pi_limit=np.float64(pi.i_limit),
        pi_integral0=np.float64(
            pi.integral_init if integral_init is None else integral_init
        ),
    )


# ---------------------------------------------------------------------------
# AFSK tone correlator (afsk.py:148-167)
# ---------------------------------------------------------------------------


class AFSKParams(NamedTuple):
    input_bpf: np.ndarray
    output_lpf: np.ndarray
    mark_i: np.ndarray
    mark_q: np.ndarray
    space_i: np.ndarray
    space_q: np.ndarray
    # polyphase upsample filter for output_oversample > 1 (afsk.py:164-165);
    # zero-length array when the branch is off (the common case)
    resample_taps: np.ndarray = np.zeros(0)
    oversample: int = 1


def _resample_poly_taps(up: int) -> np.ndarray:
    """The exact anti-imaging filter scipy.signal.resample_poly(x, up, 1)
    designs internally: kaiser(beta=5.0)-windowed sinc, cutoff 1/up,
    2*10*up+1 taps, scaled by up."""
    from scipy.signal import firwin

    half_len = 10 * up
    return up * firwin(2 * half_len + 1, 1.0 / up, window=("kaiser", 5.0))


def afsk_params(spec: AFSKModemSpec) -> AFSKParams:
    n_in = _round_taps(spec.sample_rate, spec.input_bpf_span, spec.symbol_rate)
    # tap counts derive from the OUTPUT rate for the post-resample LPF
    # (afsk.py:103-108 uses self.sample_rate; with oversample they act on the
    # upsampled stream, and the reference computes them from sample_rate --
    # we keep its arithmetic exactly)
    n_out = _round_taps(spec.sample_rate, spec.output_lpf_span, spec.symbol_rate)
    mark_i, mark_q, space_i, space_q = wd.tone_correlators(
        spec.sample_rate, spec.symbol_rate, spec.correlator_span,
        spec.mark_freq, spec.space_freq, spec.space_gain, spec.correlator_offset,
    )
    oversample = int(spec.output_oversample)
    return AFSKParams(
        input_bpf=wd.bandpass_taps(
            n_in, spec.input_bpf_low_cutoff, spec.input_bpf_high_cutoff, spec.sample_rate
        ),
        output_lpf=wd.lowpass_taps(n_out, spec.output_lpf_cutoff, spec.sample_rate),
        mark_i=mark_i, mark_q=mark_q, space_i=space_i, space_q=space_q,
        resample_taps=(
            _resample_poly_taps(oversample) if oversample > 1 else np.zeros(0)
        ),
        oversample=oversample,
    )


# ---------------------------------------------------------------------------
# AFSK PLL (afsk_pll.py:140-170)
# ---------------------------------------------------------------------------


class PLLParams(NamedTuple):
    input_bpf: np.ndarray
    output_lpf: np.ndarray
    agc: AGCParams


def afsk_pll_params(spec: AFSKPLLModemSpec) -> PLLParams:
    n_in = _round_taps(spec.sample_rate, spec.input_bpf_span, spec.symbol_rate)
    n_out = _round_taps(spec.sample_rate, spec.output_lpf_span, spec.symbol_rate)
    return PLLParams(
        input_bpf=wd.bandpass_taps(
            n_in, spec.input_bpf_low_cutoff, spec.input_bpf_high_cutoff,
            spec.sample_rate, scale=True,
        ),
        output_lpf=wd.lowpass_taps(n_out, spec.output_lpf_cutoff, spec.sample_rate),
        agc=_agc_params(spec.agc, spec.sample_rate),
    )


# ---------------------------------------------------------------------------
# BPSK Costas (psk.py:162-195)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# QPSK Costas with branch IIRs (psk.py:425-476)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# MPSK on the analytic signal (psk.py:705-773)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# FSK (fsk.py:149-159)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


