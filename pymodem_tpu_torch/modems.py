"""Modem parameters, built once on the host (numpy).

Port of the host side of ``pymodem_tpu.modems`` for every family: the
AFSK tone correlator (``afsk``), the coherent AFSK PLL (``afsk_pll``), the
BPSK Costas loop (``bpsk``), the QPSK Costas loop with branch IIRs
(``qpsk``), the PSK demodulator on the analytic signal (``mpsk``) and the
baseband FSK filter (``fsk``).  Filter design goes through the port's copy
of ``dsp/window_design.py``, so taps are identical to the JAX package's.
The demod itself runs banked, in ``runtime/bank.py``.
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
from .dsp import window_design as wd
from .dsp.loops import LoopParams

TWO_PI = 2.0 * np.pi


def _round_taps(rate: float, span: float, per: float) -> int:
    """Tap count = round(rate * span / per) with Python banker's rounding,
    as every reference tune() uses (e.g. afsk.py:103-108)."""
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
    """Loop constants of a coherent modem as numpy scalars (and the
    reference's 256-entry wavetable)."""
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
    """The anti-imaging filter scipy.signal.resample_poly(x, up, 1) designs:
    kaiser(beta=5.0)-windowed sinc, cutoff 1/up, 2*10*up+1 taps, scaled by
    up."""
    from scipy.signal import firwin

    half_len = 10 * up
    return up * firwin(2 * half_len + 1, 1.0 / up, window=("kaiser", 5.0))


def afsk_params(spec: AFSKModemSpec) -> AFSKParams:
    n_in = _round_taps(spec.sample_rate, spec.input_bpf_span, spec.symbol_rate)
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


class PSKParams(NamedTuple):
    input_bpf: np.ndarray
    rrc: np.ndarray
    agc: AGCParams


def bpsk_params(spec: BPSKModemSpec) -> PSKParams:
    n_in = _round_taps(spec.sample_rate, spec.input_bpf_span, spec.symbol_rate)
    return PSKParams(
        input_bpf=wd.bandpass_taps(
            n_in, spec.input_bpf_low_cutoff, spec.input_bpf_high_cutoff,
            spec.sample_rate, scale=True,
        ),
        rrc=wd.rrc_taps(spec.sample_rate, spec.symbol_rate, spec.rrc_span,
                        spec.rrc_rolloff_rate),
        agc=_agc_params(spec.agc, spec.sample_rate),
    )


def qpsk_params(spec: QPSKModemSpec) -> PSKParams:
    """The Costas QPSK modem's filters and AGC (psk.py:425-476); its branch
    IIR is a loop constant (``runtime/bank.py``)."""
    n_in = _round_taps(spec.sample_rate, spec.input_bpf_span, spec.symbol_rate)
    return PSKParams(
        input_bpf=wd.bandpass_taps(
            n_in, spec.input_bpf_low_cutoff, spec.input_bpf_high_cutoff,
            spec.sample_rate, scale=True,
        ),
        rrc=wd.rrc_taps(spec.sample_rate, spec.symbol_rate, spec.rrc_span,
                        spec.rrc_rolloff_rate),
        agc=_agc_params(spec.agc, spec.sample_rate),
    )


class MPSKParams(NamedTuple):
    """The JAX package's MPSKParams without its f64 ``pd_table``: the port's
    phase detector is the int32 table K6 reads (``dsp/loops.pd_error_table``,
    built per bank by ``convert.bank_params_from_jax``)."""

    input_bpf: np.ndarray
    rrc: np.ndarray
    hilbert: np.ndarray
    hilbert_delay: int
    agc: AGCParams


def mpsk_params(spec: MPSKModemSpec) -> MPSKParams:
    n_in = _round_taps(spec.sample_rate, spec.input_bpf_span_ms, 1000.0)
    n_hilbert = _round_taps(spec.sample_rate, spec.hilbert_span_ms, 1000.0)
    if n_hilbert % 2 == 0:
        n_hilbert += 1  # psk.py:661-665
    return MPSKParams(
        input_bpf=wd.bandpass_taps(
            n_in, spec.input_bpf_low_cutoff, spec.input_bpf_high_cutoff,
            spec.sample_rate, scale=True,
        ),
        rrc=wd.rrc_taps(spec.sample_rate, spec.symbol_rate, spec.rrc_span,
                        spec.rrc_rolloff_rate),
        hilbert=wd.hilbert_taps(n_hilbert),
        hilbert_delay=n_hilbert // 2,
        agc=_agc_params(spec.agc, spec.sample_rate),
    )


class FSKParams(NamedTuple):
    input_lpf: np.ndarray
    invert: bool


def fsk_params(spec: FSKModemSpec) -> FSKParams:
    """The baseband FSK modem (fsk.py:149-159): one input filter, a low-pass
    or, for the ``*-rrc`` presets, an RRC; ``invert`` negates the output."""
    if spec.input_filter_type == "rrc":
        taps = wd.rrc_taps(spec.sample_rate, spec.symbol_rate,
                           spec.input_lpf_span, spec.rrc_rolloff_rate)
    else:
        n = _round_taps(spec.sample_rate, spec.input_lpf_span, spec.symbol_rate)
        taps = wd.lowpass_taps(n, spec.input_lpf_cutoff, spec.sample_rate)
    return FSKParams(input_lpf=taps, invert=spec.invert)


_BUILDERS = {
    "afsk": afsk_params,
    "afsk_pll": afsk_pll_params,
    "bpsk": bpsk_params,
    "qpsk": qpsk_params,
    "mpsk": mpsk_params,
    "fsk": fsk_params,
}


def build_params(spec):
    return _BUILDERS[spec.kind](spec)
