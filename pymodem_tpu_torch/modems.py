"""Modem parameters (built once on the host, numpy) and whole-recording
demods (tensors).

Port of ``pymodem_tpu.modems`` for every family: the AFSK tone correlator
(``afsk``), the coherent AFSK PLL (``afsk_pll``), the BPSK Costas loop
(``bpsk``), the QPSK Costas loop with branch IIRs (``qpsk``), the PSK
demodulator on the analytic signal (``mpsk``) and the baseband FSK filter
(``fsk``).  Filter design goes through the port's copy of
``dsp/window_design.py``, so taps are identical to the JAX package's.

The banked runtime demods blocks of many chains (``runtime/bank.py``);
``demod`` here runs one chain over a whole recording, for the sequential
executor (``runtime/executor.py``): the FIRs on the direct engines of
``dsp/fir.py``, and every recurrence as its kernel at one lane (K2, K3 and
K5 with the AGC fused, K4 then K6 for ``mpsk``), with the AGC normal taken
over the whole recording (agc.py:67).  On a CPU tensor the kernels' plain
twins run.  The JAX package's f32 FIRs are FFT convolutions by default,
which round differently: float stages agree with its ``method="direct"``
to a few ulps, and decisions and packets agree with its default run.

At float64 (the parity mode) every stage runs at the audio's dtype: the
loop and AGC rows at f64, the NCO on the reference wavetable, the MPSK
detector on the reference's table, as the JAX package's f64 path; on the
card ``afsk_pll`` and ``bpsk`` run K11, ``qpsk`` K14, and ``mpsk`` K13
(its AGC) then K15.
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
import torch

from .dsp import window_design as wd
from .dsp.agc import agc_lanes
from .dsp.fir import fir_valid_multi, fir_valid_nd
from .dsp.loops import (
    LoopParams,
    afsk_pll_lanes,
    agc_lane_params,
    bpsk_costas_lanes,
    f64_nco_tables,
    lane_params_from_loop,
    mpsk_loop_lanes,
    nco_cos_table,
    nco_sine_table,
    pd_error_table,
    qpsk_costas_lanes,
)

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


# ---------------------------------------------------------------------------
# Whole-recording demods (one chain, one lane)
# ---------------------------------------------------------------------------


# the float dtypes of a demod and their numpy counterparts
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

def _scalar(value, device, dtype=torch.float32) -> torch.Tensor:
    """(1,) ``dtype`` tensor of a host scalar, rounded once from float64 as
    the JAX package's ``jnp.asarray(v, dtype)``."""
    return torch.tensor([_NP_DTYPE[dtype](value)], device=device)


def agc_rows(agc: AGCParams, x: torch.Tensor) -> torch.Tensor:
    """(5, 1) AGC lane rows (kernel K4's, or the fused AGC's of K2, K3, K5
    and K11) at ``x``'s dtype for the whole recording ``x``: the steps
    scaled by its signed max (agc.py:67)."""
    leaves = {k: _scalar(v, x.device, x.dtype)
              for k, v in agc._asdict().items()}
    return agc_lane_params(leaves, x.max().reshape(1), 1, 1, x.dtype)


def _apply_agc(audio: torch.Tensor, agc: AGCParams) -> torch.Tensor:
    """The AGC over a whole recording: kernel K4 at one lane (its twin on
    the CPU)."""
    return agc_lanes(audio[None], agc_rows(agc, audio).contiguous())[0]


def _loop_rows(spec, dtype=torch.float32) -> torch.Tensor:
    """(10, 1) ``dtype`` loop lane rows of a coherent modem
    (``PLL_PARAMS``)."""
    loop = {k: _NP_DTYPE[dtype](v) for k, v in _loop_params_host(spec)
            ._asdict().items() if k != "wavetable"}
    return lane_params_from_loop({k: torch.tensor([v]) for k, v in
                                  loop.items()}, 1, 1, dtype)


def coherent_loop_inputs(spec, params, audio: torch.Tensor):
    """(band-passed (1, n) row, its lane rows) of kernel K2, K3, K5 or K11
    over a whole recording, at the audio's dtype: the loop's 10 rows, for
    ``qpsk`` the branch IIR's 2, then the fused AGC's 5 (normal over the
    whole recording)."""
    x = fir_valid_nd(audio, params.input_bpf)
    rows = [_loop_rows(spec, x.dtype).to(x.device)]
    if spec.kind == "qpsk":
        b0, a1 = wd.iir1_lpf_coefs(spec.sample_rate, spec.branch_lpf_cutoff,
                                   1.0)
        rows += [_scalar(b0, x.device, x.dtype)[None],
                 _scalar(a1, x.device, x.dtype)[None]]
    rows.append(agc_rows(params.agc, x))
    return x[None], torch.cat(rows).contiguous()


def nco_tables(device, dtype=torch.float32
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The NCO's (256,) sine and cosine tables on ``device``: at float32
    the quantised angles' (``nco_sine_table``), at float64 the reference
    wavetable gathered as the JAX package's f64 NCO does
    (``f64_nco_tables``)."""
    if dtype == torch.float64:
        tables = f64_nco_tables(wd.nco_wavetable(256, 1.0))
    else:
        tables = (nco_sine_table(), nco_cos_table())
    return tuple(torch.from_numpy(t).to(device) for t in tables)


def mpsk_loop_inputs(spec, params, audio: torch.Tensor):
    """The inputs of kernel K6 over a whole recording: the analytic (real,
    imag) rows (1, n) -- band-pass FIR, the AGC (K4), the Hilbert FIR and
    its delay (psk.py:714-716) -- the (12, 1) lane rows, the (1, g*g)
    phase-detector table (at float64 the reference's table, as the JAX
    package's f64 detector gathers it) and the lane's table index (1,)."""
    leveled = _apply_agc(fir_valid_nd(audio, params.input_bpf), params.agc)
    imag = fir_valid_nd(leveled, params.hilbert)
    d = params.hilbert_delay
    real = leveled[d:-d] if d else leveled
    dev = leveled.device
    dtype = leveled.dtype
    rows = torch.cat([_loop_rows(spec, dtype).to(dev),
                      _scalar(spec.pd_gain, dev, dtype)[None],
                      _scalar(spec.pd_granularity, dev, dtype)[None]]
                     ).contiguous()
    g, gain = int(spec.pd_granularity), float(spec.pd_gain)
    table = torch.from_numpy(
        wd.qpsk_error_table(g, gain).astype(np.int32).reshape(-1)
        if dtype == torch.float64 else pd_error_table(g, gain))
    return (real[None].contiguous(), imag[None].contiguous(), rows,
            table[None].to(dev), torch.zeros(1, dtype=torch.int32,
                                             device=dev))


def _upsample_poly(x: torch.Tensor, taps, up: int) -> torch.Tensor:
    """scipy.signal.resample_poly(x, up, 1) as the JAX package computes it:
    zero-stuff to n*up, then the centred kaiser FIR (odd taps, a 'valid'
    convolution of the half-padded stream); output length n*up."""
    n = x.shape[-1]
    stuffed = x.new_zeros(x.shape[:-1] + (n * up,))
    stuffed[..., ::up] = x
    half = (len(taps) - 1) // 2
    return fir_valid_nd(torch.nn.functional.pad(stuffed, (half, half)), taps)


def afsk_demod(params: AFSKParams, audio: torch.Tensor) -> torch.Tensor:
    """Band-pass FIR, the four tone correlators, mark minus space
    magnitude, the optional polyphase upsample, the output LPF."""
    filtered = fir_valid_nd(audio, params.input_bpf)
    corr = np.stack([params.mark_i, params.mark_q, params.space_i,
                     params.space_q])
    mi, mq, si, sq = fir_valid_multi(filtered, corr)
    diff = torch.sqrt(mi * mi + mq * mq) - torch.sqrt(si * si + sq * sq)
    if params.oversample > 1:
        diff = _upsample_poly(diff, params.resample_taps, params.oversample)
    return fir_valid_nd(diff, params.output_lpf)


def afsk_pll_demod(spec: AFSKPLLModemSpec, params: PLLParams,
                   audio: torch.Tensor) -> torch.Tensor:
    """Band-pass FIR, the AGC and PLL as kernel K2 (K11 at float64) at one
    lane, the output LPF."""
    x, rows = coherent_loop_inputs(spec, params, audio)
    sine, _ = nco_tables(audio.device, audio.dtype)
    return fir_valid_nd(afsk_pll_lanes(x, rows, sine)[0], params.output_lpf)


def bpsk_demod(spec: BPSKModemSpec, params: PSKParams,
               audio: torch.Tensor) -> torch.Tensor:
    """Band-pass FIR, the AGC and Costas loop as kernel K3 (K11 at float64)
    at one lane, the RRC."""
    x, rows = coherent_loop_inputs(spec, params, audio)
    return fir_valid_nd(bpsk_costas_lanes(
        x, rows, *nco_tables(audio.device, audio.dtype))[0], params.rrc)


def qpsk_demod(spec: QPSKModemSpec, params: PSKParams,
               audio: torch.Tensor):
    """Band-pass FIR, the AGC and Costas loop with branch IIRs as kernel K5
    at one lane, the RRC on both rails; returns (i, q)."""
    x, rows = coherent_loop_inputs(spec, params, audio)
    i_d, q_d = qpsk_costas_lanes(x, rows,
                                 *nco_tables(audio.device, audio.dtype))
    return fir_valid_nd(i_d[0], params.rrc), fir_valid_nd(q_d[0], params.rrc)


def mpsk_demod(spec: MPSKModemSpec, params: MPSKParams,
               audio: torch.Tensor):
    """The analytic signal (``mpsk_loop_inputs``), the loop as kernel K6 at
    one lane, the RRC on both rails; returns (i, q)."""
    re, im, rows, table, index = mpsk_loop_inputs(spec, params, audio)
    i_d, q_d = mpsk_loop_lanes(re, im, rows,
                               *nco_tables(audio.device, audio.dtype),
                               table, index)
    return fir_valid_nd(i_d[0], params.rrc), fir_valid_nd(q_d[0], params.rrc)


def fsk_demod(params: FSKParams, audio: torch.Tensor) -> torch.Tensor:
    out = fir_valid_nd(audio, params.input_lpf)
    return -out if params.invert else out


def demod(spec, params, audio: torch.Tensor):
    """A whole-recording baseband (n,), or an (i, q) pair for ``qpsk`` and
    ``mpsk``, from float32 or float64 audio (n,); every stage runs at the
    audio's dtype (float64 on the card: the f64 kernels K11, K13-K15)."""
    kind = spec.kind
    if kind == "afsk":
        return afsk_demod(params, audio)
    if kind == "fsk":
        return fsk_demod(params, audio)
    return {"afsk_pll": afsk_pll_demod, "bpsk": bpsk_demod,
            "qpsk": qpsk_demod, "mpsk": mpsk_demod}[kind](spec, params, audio)
