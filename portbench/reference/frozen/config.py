# Frozen copy of the JAX package's pymodem_tpu/config.py at commit
# 0117b87; its jax imports and device functions left out. The benchmark's
# reference: it is not the port's code, and it is not edited to follow
# either package.
"""Config layer: JSONL chain plans -> typed chain specifications.

The reference (pymodem) drives everything from a JSONL file where each line is
either a ``demod_chain`` or a ``report`` object (reference: pymodem.py:35-132).
A chain is four stages -- modem, slicer, stream, codec -- each selected by a
``type`` string, parameterized by a ``config`` preset name, and then overridden
by stringly-typed ``options`` (reference: modems_codecs/chain_builder.py).

This module performs the same two-phase resolution (preset, then options) but
produces frozen, hashable spec dataclasses that the runtime compiles into JAX
programs.  All numeric state lives here on the host; nothing in this module
touches a device.

Unknown option keys are silently ignored, matching the reference's
``dict.get`` behaviour (e.g. modems_codecs/afsk.py:87-100), which some bundled
configs rely on (``"mark freq"`` with a space is ignored and the preset default
is used; see configs/afsk_300.json).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, replace
from typing import Any


def _truthy(text: str) -> bool:
    """String->bool with the reference's semantics (string_ops.py:6-15)."""
    return str(text).lower() in ("yes", "true", "1")


# ---------------------------------------------------------------------------
# Modem specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AFSKModemSpec:
    """Non-coherent AFSK tone-correlator demodulator (afsk.py:13-167)."""

    kind: str = "afsk"
    sample_rate: float = 8000.0
    symbol_rate: float = 1200.0
    input_bpf_low_cutoff: float = 900.0
    input_bpf_high_cutoff: float = 2500.0
    input_bpf_span: float = 3.7
    mark_freq: float = 1200.0
    space_freq: float = 2200.0
    space_gain: float = 1.0
    output_lpf_cutoff: float = 1400.0
    output_lpf_span: float = 2.5
    correlator_span: float = 1.0
    correlator_offset: float = 0.0
    # afsk.py:68 fixes this at 1.0 (no StringOptionsRetune key), but the
    # demod path at afsk.py:164-165 honors >1: polyphase upsample before the
    # output LPF, output_sample_rate scaled (afsk.py:146).  Exposed here as a
    # config option; handled by the sequential runtime.
    output_oversample: float = 1.0

    _OPTION_KEYS = (
        "symbol_rate",
        "input_bpf_low_cutoff",
        "input_bpf_high_cutoff",
        "input_bpf_span",
        "output_lpf_cutoff",
        "output_lpf_span",
        "sample_rate",
        "space_gain",
        "mark_freq",
        "space_freq",
        "correlator_span",
        "correlator_offset",
        "output_oversample",
    )

    @property
    def output_sample_rate(self) -> float:
        # afsk.py:146: output_oversample * sample_rate
        return self.output_oversample * self.sample_rate


_AFSK_PRESETS: dict[str, dict[str, float]] = {
    # afsk.py:19-42
    "300": dict(
        symbol_rate=300.0,
        input_bpf_low_cutoff=1500.0,
        input_bpf_high_cutoff=1900.0,
        input_bpf_span=7.0,
        mark_freq=1695.0,
        space_freq=1705.0,
        space_gain=1.0,
        output_lpf_cutoff=240.0,
        output_lpf_span=2.5,
        correlator_span=0.3,
        correlator_offset=0.0,
    ),
    # afsk.py:43-66 (default preset for any other config string)
    "1200": dict(
        symbol_rate=1200.0,
        input_bpf_low_cutoff=900.0,
        input_bpf_high_cutoff=2500.0,
        input_bpf_span=3.7,
        mark_freq=1200.0,
        space_freq=2200.0,
        space_gain=1.0,
        output_lpf_cutoff=1400.0,
        output_lpf_span=2.5,
        correlator_span=1.0,
        correlator_offset=0.0,
    ),
}


@dataclass(frozen=True)
class PIControlSpec:
    """PI feedback controller constants (pi_control.py:7-13)."""

    p: float
    i: float
    i_limit: float
    gain: float
    # MPSK pre-seeds the integral to -max_freq_offset (psk.py:703).
    integral_init: float = 0.0


@dataclass(frozen=True)
class IIR1Spec:
    """First order bilinear-transform LPF constants (iir.py:9-35)."""

    sample_rate: float
    cutoff: float
    gain: float = 1.0


@dataclass(frozen=True)
class AGCSpec:
    """Envelope-follower AGC constants (agc.py:7-24)."""

    attack_rate: float
    sustain_time: float
    decay_rate: float
    target_amplitude: float = 1.0


@dataclass(frozen=True)
class AFSKPLLModemSpec:
    """Coherent AFSK PLL demodulator (afsk_pll.py:16-170).

    Only the '300' preset exists in the reference (afsk_pll.py:22-52).
    """

    kind: str = "afsk_pll"
    sample_rate: float = 8000.0
    symbol_rate: float = 300.0
    input_bpf_low_cutoff: float = 1500.0
    input_bpf_high_cutoff: float = 1900.0
    input_bpf_span: float = 7.0
    carrier_freq: float = 1700.0
    output_lpf_cutoff: float = 240.0
    output_lpf_span: float = 5.0
    max_freq_offset: float = 50.0
    agc: AGCSpec = field(
        default_factory=lambda: AGCSpec(attack_rate=500.0, sustain_time=1.0, decay_rate=50.0)
    )
    loop_lpf_cutoff: float = 150.0
    pi: PIControlSpec = field(
        default_factory=lambda: PIControlSpec(p=0.6, i=0.6 / 6000, i_limit=50.0, gain=900.0)
    )

    _OPTION_KEYS = (
        "symbol_rate",
        "input_bpf_low_cutoff",
        "input_bpf_high_cutoff",
        "input_bpf_span",
        "output_lpf_cutoff",
        "output_lpf_span",
        "sample_rate",
        "carrier_freq",
    )

    @property
    def output_sample_rate(self) -> float:
        return self.sample_rate


@dataclass(frozen=True)
class BPSKModemSpec:
    """BPSK Costas-loop demodulator (psk.py:20-195)."""

    kind: str = "bpsk"
    sample_rate: float = 8000.0
    symbol_rate: float = 300.0
    input_bpf_low_cutoff: float = 1200.0
    input_bpf_high_cutoff: float = 1800.0
    input_bpf_span: float = 1.5
    carrier_freq: float = 1500.0
    rrc_rolloff_rate: float = 0.6
    rrc_span: float = 6.0
    max_freq_offset: float = 25 * 1.25
    agc: AGCSpec = field(
        default_factory=lambda: AGCSpec(attack_rate=500.0, sustain_time=1.0, decay_rate=50.0)
    )
    loop_lpf_cutoff: float = 250.0
    pi: PIControlSpec = field(
        default_factory=lambda: PIControlSpec(p=0.06, i=0.06 / 1000, i_limit=25 * 1.25, gain=7200.0)
    )

    _OPTION_KEYS = (
        "symbol_rate",
        "input_bpf_low_cutoff",
        "input_bpf_high_cutoff",
        "input_bpf_span",
        "sample_rate",
        "carrier_freq",
    )

    @property
    def output_sample_rate(self) -> float:
        return self.sample_rate


def _bpsk_preset(config: str, sample_rate: float) -> BPSKModemSpec:
    if config == "1200":
        # psk.py:56-85
        return BPSKModemSpec(
            sample_rate=sample_rate,
            symbol_rate=1200.0,
            input_bpf_low_cutoff=200.0,
            input_bpf_high_cutoff=2800.0,
            input_bpf_span=4.80,
            carrier_freq=1500.0,
            rrc_rolloff_rate=0.9,
            rrc_span=6.0,
            max_freq_offset=50 * 1.25,
            loop_lpf_cutoff=250.0,
            pi=PIControlSpec(p=0.4, i=0.4 / 1000, i_limit=50 * 1.25, gain=1800.0),
        )
    # psk.py:26-55 ('300')
    return BPSKModemSpec(sample_rate=sample_rate)


@dataclass(frozen=True)
class QPSKModemSpec:
    """QPSK Costas-loop demodulator with I/Q branch IIRs (psk.py:197-476)."""

    kind: str = "qpsk"
    sample_rate: float = 44100.0
    symbol_rate: float = 300.0
    input_bpf_low_cutoff: float = 1200.0
    input_bpf_high_cutoff: float = 1800.0
    input_bpf_span: float = 1.5
    carrier_freq: float = 1500.0
    output_lpf_cutoff: float = 200.0
    output_lpf_span: float = 1.5
    rrc_rolloff_rate: float = 0.6
    rrc_span: float = 6.0
    max_freq_offset: float = 37.5
    agc: AGCSpec = field(
        default_factory=lambda: AGCSpec(attack_rate=500.0, sustain_time=1.0, decay_rate=50.0)
    )
    branch_lpf_cutoff: float = 300.0
    loop_lpf_cutoff: float = 100.0
    pi: PIControlSpec = field(
        default_factory=lambda: PIControlSpec(p=0.02, i=0.02 / 651, i_limit=37.5, gain=858.0)
    )

    _OPTION_KEYS = (
        "symbol_rate",
        "input_bpf_low_cutoff",
        "input_bpf_high_cutoff",
        "input_bpf_span",
        "output_lpf_cutoff",
        "output_lpf_span",
        "sample_rate",
        "carrier_freq",
    )

    @property
    def output_sample_rate(self) -> float:
        return self.sample_rate


def _qpsk_preset(config: str, sample_rate: float) -> QPSKModemSpec:
    if config == "3600":
        # psk.py:248-292
        return QPSKModemSpec(
            sample_rate=sample_rate,
            symbol_rate=1800.0,
            input_bpf_low_cutoff=300.0,
            input_bpf_high_cutoff=3000.0,
            input_bpf_span=5.0,
            carrier_freq=1650.0,
            output_lpf_cutoff=900.0,
            output_lpf_span=1.5,
            max_freq_offset=50.0,
            rrc_rolloff_rate=0.3,
            rrc_span=8.0,
            agc=AGCSpec(attack_rate=5000.0, sustain_time=0.1, decay_rate=50.0),
            branch_lpf_cutoff=1450.0,
            loop_lpf_cutoff=200.0,
            pi=PIControlSpec(p=0.15, i=0.15 / 1000, i_limit=50.0, gain=1350.0),
        )
    if config == "2400":
        # psk.py:293-338
        return QPSKModemSpec(
            sample_rate=sample_rate,
            symbol_rate=1200.0,
            input_bpf_low_cutoff=200.0,
            input_bpf_high_cutoff=2800.0,
            input_bpf_span=4.8,
            carrier_freq=1800.0,
            output_lpf_cutoff=900.0,
            output_lpf_span=1.5,
            max_freq_offset=87.5,
            rrc_rolloff_rate=0.9,
            rrc_span=3.0,
            agc=AGCSpec(attack_rate=500.0, sustain_time=1.0, decay_rate=50.0),
            branch_lpf_cutoff=1200.0,
            loop_lpf_cutoff=200.0,
            pi=PIControlSpec(p=0.1, i=0.1 / 500, i_limit=87.5, gain=450.0),
        )
    # psk.py:203-247 ('600')
    return QPSKModemSpec(sample_rate=sample_rate)


@dataclass(frozen=True)
class MPSKModemSpec:
    """PSK demodulator on the analytic (Hilbert) signal (psk.py:479-773)."""

    kind: str = "mpsk"
    constellation: str = "qpsk"
    sample_rate: float = 44100.0
    symbol_rate: float = 1800.0
    input_bpf_low_cutoff: float = 300.0
    input_bpf_high_cutoff: float = 3000.0
    input_bpf_span_ms: float = 2.0  # milliseconds (psk.py:494)
    hilbert_span_ms: float = 4.5  # milliseconds (psk.py:495)
    carrier_freq: float = 1650.0
    max_freq_offset: float = 12.5 * 1.25
    rrc_rolloff_rate: float = 0.3
    rrc_span: float = 6.0
    agc: AGCSpec = field(
        default_factory=lambda: AGCSpec(attack_rate=5000.0, sustain_time=0.1, decay_rate=50.0)
    )
    loop_lpf_cutoff: float = 250.0
    pi: PIControlSpec = field(
        default_factory=lambda: PIControlSpec(
            p=0.15, i=0.15 / 1000, i_limit=12.5 * 1.25, gain=14400 / 65536,
            integral_init=-12.5 * 1.25,
        )
    )
    pd_granularity: int = 64
    pd_gain: float = 32.0

    _OPTION_KEYS = ("symbol_rate", "sample_rate", "carrier_freq")

    @property
    def output_sample_rate(self) -> float:
        return self.sample_rate


def _mpsk_preset(config: str, sample_rate: float) -> MPSKModemSpec:
    if config == "qpsk_600":
        # psk.py:514-541
        return MPSKModemSpec(
            constellation="qpsk",
            sample_rate=sample_rate,
            symbol_rate=300.0,
            input_bpf_low_cutoff=1200.0,
            input_bpf_high_cutoff=1800.0,
            input_bpf_span_ms=4.0,
            hilbert_span_ms=3.4,
            carrier_freq=1500.0,
            max_freq_offset=25.0,
            rrc_rolloff_rate=0.6,
            rrc_span=6.0,
            agc=AGCSpec(attack_rate=500.0, sustain_time=1.0, decay_rate=50.0),
            loop_lpf_cutoff=150.0,
            pi=PIControlSpec(
                p=0.1, i=0.1 / 1000, i_limit=25.0, gain=7200 / 65536, integral_init=-25.0
            ),
        )
    if config == "qpsk_2400":
        # psk.py:542-569
        return MPSKModemSpec(
            constellation="qpsk",
            sample_rate=sample_rate,
            symbol_rate=1200.0,
            input_bpf_low_cutoff=200.0,
            input_bpf_high_cutoff=2800.0,
            input_bpf_span_ms=2.7,
            hilbert_span_ms=3.4,
            carrier_freq=1500.0,
            max_freq_offset=25 * 1.25,
            rrc_rolloff_rate=0.9,
            rrc_span=6.0,
            agc=AGCSpec(attack_rate=500.0, sustain_time=1.0, decay_rate=50.0),
            loop_lpf_cutoff=250.0,
            pi=PIControlSpec(
                p=0.3, i=0.3 / 2000, i_limit=25 * 1.25, gain=14400 / 65536,
                integral_init=-25 * 1.25,
            ),
        )
    if config == "bpsk_300":
        # psk.py:570-597
        return MPSKModemSpec(
            constellation="bpsk",
            sample_rate=sample_rate,
            symbol_rate=300.0,
            input_bpf_low_cutoff=1200.0,
            input_bpf_high_cutoff=1800.0,
            input_bpf_span_ms=2.7,
            hilbert_span_ms=2.7,
            carrier_freq=1500.0,
            max_freq_offset=50.0,
            rrc_rolloff_rate=0.6,
            rrc_span=6.0,
            agc=AGCSpec(attack_rate=500.0, sustain_time=1.0, decay_rate=50.0),
            loop_lpf_cutoff=250.0,
            pi=PIControlSpec(
                p=0.15, i=0.15 / 1000, i_limit=50.0, gain=1.5 * 500, integral_init=-50.0
            ),
        )
    if config == "bpsk_1200":
        # psk.py:598-628.  NB: the reference comments say "symbols" for the
        # spans here but tune() divides by 1000 regardless (psk.py:641-648),
        # so these are effectively milliseconds like every other mpsk preset.
        return MPSKModemSpec(
            constellation="bpsk",
            sample_rate=sample_rate,
            symbol_rate=1200.0,
            input_bpf_low_cutoff=200.0,
            input_bpf_high_cutoff=2800.0,
            input_bpf_span_ms=4.8,
            hilbert_span_ms=2.0,
            carrier_freq=1500.0,
            max_freq_offset=87.5,
            rrc_rolloff_rate=0.9,
            rrc_span=6.0,
            agc=AGCSpec(attack_rate=500.0, sustain_time=1.0, decay_rate=50.0),
            loop_lpf_cutoff=200.0,
            pi=PIControlSpec(p=0.15, i=0.15 / 1000, i_limit=87.5, gain=5.0, integral_init=-87.5),
        )
    # psk.py:485-513 ('qpsk_3600', also the implicit default)
    return MPSKModemSpec(sample_rate=sample_rate)


@dataclass(frozen=True)
class FSKModemSpec:
    """Direct (already-baseband) FSK demodulator (fsk.py:15-159).

    NB: the reference constructs an AGC here but never applies it in demod
    (fsk.py:140-159); demod is filter (+ optional negate) only.
    """

    kind: str = "fsk"
    sample_rate: float = 96000.0
    symbol_rate: float = 9600.0
    input_filter_type: str = "lpf"  # 'lpf' | 'rrc'
    input_lpf_cutoff: float = 6000.0
    input_lpf_span: float = 1.5
    rrc_rolloff_rate: float = 0.0
    invert: bool = False

    @property
    def output_sample_rate(self) -> float:
        # FSKModem never sets output_sample_rate, so the driver falls back to
        # the *input* sample rate for the slicer (pymodem.py:87-90).
        return self.sample_rate


def _fsk_preset(config: str, sample_rate: float) -> FSKModemSpec:
    presets = {
        # fsk.py:25-35
        "9600": dict(symbol_rate=9600.0, input_filter_type="lpf", input_lpf_cutoff=6000.0,
                     input_lpf_span=1.5),
        # fsk.py:36-44
        "4800": dict(symbol_rate=4800.0, input_filter_type="lpf", input_lpf_cutoff=3000.0,
                     input_lpf_span=1.5),
        # fsk.py:45-56
        "4800-rrc": dict(symbol_rate=4800.0, input_filter_type="rrc", rrc_rolloff_rate=0.2,
                         input_lpf_span=9.0),
        # fsk.py:57-68
        "9600-rrc": dict(symbol_rate=9600.0, input_filter_type="rrc", rrc_rolloff_rate=0.2,
                         input_lpf_span=9.0),
        # fsk.py:69-80
        "4800-gauss": dict(symbol_rate=4800.0, input_filter_type="lpf",
                           input_lpf_cutoff=0.9 * 4800.0, input_lpf_span=4.0),
        # fsk.py:81-92
        "9600-gauss": dict(symbol_rate=9600.0, input_filter_type="lpf",
                           input_lpf_cutoff=0.9 * 9600.0, input_lpf_span=4.0),
    }
    kw = presets.get(config, presets["9600"])
    return FSKModemSpec(sample_rate=sample_rate, **kw)


# ---------------------------------------------------------------------------
# Slicer / stream / codec specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BinarySlicerSpec:
    """2-level symbol-timing-recovery slicer (slicer.py:9-107)."""

    kind: str = "binary"
    sample_rate: float = 8000.0
    symbol_rate: float = 1200.0
    lock_rate: float = 0.75


_BINARY_SLICER_PRESETS = {
    # slicer.py:22-33
    "300": dict(symbol_rate=300.0, lock_rate=0.75),
    "9600": dict(symbol_rate=9600.0, lock_rate=0.88),
    "4800": dict(symbol_rate=4800.0, lock_rate=0.88),
}


@dataclass(frozen=True)
class QuadratureSlicerSpec:
    """IQ symbol-timing slicer with 2-bit demap (slicer.py:109-242)."""

    kind: str = "quadrature"
    sample_rate: float = 8000.0
    symbol_rate: float = 1200.0
    lock_rate: float = 0.9
    bits_per_symbol: int = 2
    state_mask: int = 0xF
    demap: tuple[int, ...] = (3, 1, 2, 0, 2, 3, 0, 1, 1, 0, 3, 2, 0, 2, 1, 3)


_QPSK_DEMAP = (3, 1, 2, 0, 2, 3, 0, 1, 1, 0, 3, 2, 0, 2, 1, 3)
_BPSK_DEMAP = (0, 0, 1, 1)

_QUAD_SLICER_PRESETS = {
    # slicer.py:124-165
    "qpsk_600": dict(state_mask=0xF, bits_per_symbol=2, demap=_QPSK_DEMAP,
                     symbol_rate=300.0, lock_rate=0.815),
    "bpsk_300": dict(state_mask=0x3, bits_per_symbol=1, demap=_BPSK_DEMAP,
                     symbol_rate=300.0, lock_rate=0.815),
    "bpsk_1200": dict(state_mask=0x3, bits_per_symbol=1, demap=_BPSK_DEMAP,
                      symbol_rate=1200.0, lock_rate=0.9),
    "qpsk_2400": dict(state_mask=0xF, bits_per_symbol=2, demap=_QPSK_DEMAP,
                      symbol_rate=1200.0, lock_rate=0.9),
    "qpsk_4800": dict(state_mask=0xF, bits_per_symbol=2, demap=_QPSK_DEMAP,
                      symbol_rate=2400.0, lock_rate=0.99),
    "qpsk_3600": dict(state_mask=0xF, bits_per_symbol=2, demap=_QPSK_DEMAP,
                      symbol_rate=1800.0, lock_rate=0.99),
}


@dataclass(frozen=True)
class FourLevelSlicerSpec:
    """4-level (4FSK) slicer with sync-pattern threshold (slicer.py:244-441).

    The reference version crashes at construction (undefined ``AGC`` import)
    and at the end of slice() (undefined ``plot``); this spec describes the
    intended working behaviour, which we implement fix-forward.
    """

    kind: str = "4level"
    sample_rate: float = 8000.0
    symbol_rate: float = 4800.0
    lock_rate: float = 0.985
    fast_envelope_attack_rate: float = 1000000.0
    fast_envelope_sustain_time: float = 2 / 4800
    fast_envelope_decay_rate: float = 50.0
    slow_envelope_attack_rate: float = 50.0
    slow_envelope_sustain_time: float = 40 / 4800
    slow_envelope_decay_rate: float = 50.0
    # symbol_map [1, 3, -1, -3] (slicer.py:270) yields demap [2, 0, 3, 1]
    # via the inversion loop at slicer.py:297-308.
    demap: tuple[int, ...] = (2, 0, 3, 1)


def _four_level_preset(config: str, sample_rate: float) -> FourLevelSlicerSpec:
    if config == "9600":
        return FourLevelSlicerSpec(
            sample_rate=sample_rate,
            symbol_rate=9600.0,
            lock_rate=0.985,
            fast_envelope_sustain_time=2 / 9600,
            slow_envelope_sustain_time=40 / 9600,
        )
    return FourLevelSlicerSpec(sample_rate=sample_rate)


@dataclass(frozen=True)
class LFSRStreamSpec:
    """Free-running multiplicative descrambler (lfsr.py:10-52)."""

    kind: str = "lfsr"
    polynomial: int = 0x1
    invert: bool = False


@dataclass(frozen=True)
class AX25CodecSpec:
    """HDLC bit-unstuffing deframer (ax25.py:11-93)."""

    kind: str = "ax25"
    ident: str = ""
    min_packet_length: int = 18
    max_packet_length: int = 1023


@dataclass(frozen=True)
class IL2PCodecSpec:
    """IL2P Reed-Solomon framed codec (il2p.py:109-519)."""

    kind: str = "il2p"
    ident: str = ""
    collect_trailing_crc: bool = True
    disable_rs: bool = False
    min_distance: int = 0
    sync_tolerance: int = 0


@dataclass(frozen=True)
class ChainSpec:
    name: str
    modem: Any
    slicer: Any
    stream: LFSRStreamSpec | None
    codec: Any


@dataclass(frozen=True)
class ReportSpec:
    name: str
    style: str = "raw"
    destination: str = "std_out"


@dataclass(frozen=True)
class RunPlan:
    chains: tuple[ChainSpec, ...]
    reports: tuple[ReportSpec, ...]


# ---------------------------------------------------------------------------
# Resolution: JSON objects -> specs
# ---------------------------------------------------------------------------


def _apply_float_options(spec, options: dict[str, Any]):
    """Override spec fields from stringly-typed options, floats only.

    Mirrors each modem's StringOptionsRetune: only whitelisted keys are read
    and every value passes through float() (e.g. afsk.py:87-100).
    """
    updates = {}
    for key in spec._OPTION_KEYS:
        if key in options:
            updates[key] = float(options[key])
    return replace(spec, **updates) if updates else spec


def build_modem_spec(sample_rate: float, modem_cfg: dict[str, Any]):
    kind = modem_cfg.get("type")
    config = modem_cfg.get("config", "")
    options = modem_cfg.get("options", {})
    if kind == "afsk":
        preset = _AFSK_PRESETS.get(config, _AFSK_PRESETS["1200"])
        spec = AFSKModemSpec(sample_rate=float(sample_rate), **preset)
        return _apply_float_options(spec, options)
    if kind == "afsk_pll":
        if config != "300":
            # The reference only defines a '300' preset; any other string
            # raises at tune() (afsk_pll.py:22-52).  We reject it up front.
            raise ValueError(f"afsk_pll has no preset {config!r}")
        spec = AFSKPLLModemSpec(sample_rate=float(sample_rate))
        return _apply_float_options(spec, options)
    if kind == "bpsk":
        spec = _bpsk_preset(config, float(sample_rate))
        return _apply_float_options(spec, options)
    if kind == "qpsk":
        spec = _qpsk_preset(config, float(sample_rate))
        return _apply_float_options(spec, options)
    if kind == "mpsk":
        spec = _mpsk_preset(config, float(sample_rate))
        return _apply_float_options(spec, options)
    if kind == "fsk":
        spec = _fsk_preset(config, float(sample_rate))
        if "invert" in options:
            spec = replace(spec, invert=_truthy(options["invert"]))
        return spec
    raise ValueError(f"unknown modem type {kind!r}")


def build_slicer_spec(sample_rate: float, slicer_cfg: dict[str, Any]):
    kind = slicer_cfg.get("type")
    config = slicer_cfg.get("config", "")
    options = slicer_cfg.get("options", {})
    if kind == "binary":
        preset = _BINARY_SLICER_PRESETS.get(config, dict(symbol_rate=1200.0, lock_rate=0.75))
        spec = BinarySlicerSpec(sample_rate=sample_rate, **preset)
    elif kind == "quadrature":
        preset = _QUAD_SLICER_PRESETS.get(config, _QUAD_SLICER_PRESETS["qpsk_2400"])
        spec = QuadratureSlicerSpec(sample_rate=sample_rate, **preset)
    elif kind == "4level":
        spec = _four_level_preset(config, sample_rate)
    else:
        raise ValueError(f"unknown slicer type {kind!r}")
    # StringOptionsRetune on every slicer reads only lock_rate as float;
    # symbol_rate/sample_rate overrides pass through untouched types
    # (slicer.py:43-47) -- no bundled config uses them, so we accept floats.
    updates = {}
    if "lock_rate" in options:
        updates["lock_rate"] = float(options["lock_rate"])
    if "symbol_rate" in options:
        updates["symbol_rate"] = float(options["symbol_rate"])
    if "sample_rate" in options:
        updates["sample_rate"] = float(options["sample_rate"])
    return replace(spec, **updates) if updates else spec


def build_stream_spec(stream_cfg: dict[str, Any]) -> LFSRStreamSpec | None:
    if stream_cfg.get("type") != "lfsr":
        return None
    options = stream_cfg.get("options", {})
    poly = int(options.get("poly", "0x1"), 16)
    invert = _truthy(options.get("invert", "false"))
    return LFSRStreamSpec(polynomial=poly, invert=invert)


def build_codec_spec(codec_cfg: dict[str, Any], name: str):
    kind = codec_cfg.get("type", "").lower()
    options = codec_cfg.get("options", {})
    if kind == "ax25":
        return AX25CodecSpec(ident=name)
    if kind == "il2p":
        return IL2PCodecSpec(
            ident=name,
            collect_trailing_crc=_truthy(options.get("crc", "yes")),
            disable_rs=_truthy(options.get("disable_rs", "no")),
            min_distance=int(options.get("min_dist", 0)),
            sync_tolerance=int(options.get("sync_tol", 0)),
        )
    raise ValueError(f"unknown codec type {kind!r}")


def build_chain_spec(sample_rate: float, line: dict[str, Any]) -> ChainSpec:
    name = line["object_name"]
    modem = build_modem_spec(sample_rate, line["modem"])
    slicer = build_slicer_spec(modem.output_sample_rate, line["slicer"])
    stream = build_stream_spec(line.get("stream", {}))
    codec = build_codec_spec(line["codec"], name)
    return ChainSpec(name=name, modem=modem, slicer=slicer, stream=stream, codec=codec)


def load_plan(path: str, sample_rate: float) -> RunPlan:
    """Parse a JSONL chain-plan file (pymodem.py:35-43, 58-132)."""
    chains: list[ChainSpec] = []
    reports: list[ReportSpec] = []
    with open(path) as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw:
                continue
            line = json.loads(raw)
            otype = line.get("object_type")
            if otype == "demod_chain":
                chains.append(build_chain_spec(sample_rate, line))
            elif otype == "report":
                opts = line.get("options", {})
                reports.append(
                    ReportSpec(
                        name=line.get("object_name", "report"),
                        style=opts.get("style", "raw"),
                        destination=opts.get("destination", "std_out"),
                    )
                )
    return RunPlan(chains=tuple(chains), reports=tuple(reports))
