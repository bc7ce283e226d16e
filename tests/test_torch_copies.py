"""The port's own copies of the JAX package's jax-free host modules.

``pymodem_tpu_torch`` imports nothing of ``pymodem_tpu``, so it carries
copies of ``config``, ``dsp/window_design``, ``ops/hamming``,
``synth/modulate`` and ``wav_io``, and re-homed copies of the AX.25
deframer (``codecs/host``) and encoders (``synth/encode``,
``synth/fixtures``).  Each copy must equal its original: the same specs for
every preset of every modem and slicer type, the same filter taps and
tables bitwise, the same packets, bits and audio sample for sample.
"""

import dataclasses
import json

import numpy as np
import pytest

from pymodem_tpu import config as jcfg
from pymodem_tpu import wav_io as jwav
from pymodem_tpu.dsp import window_design as jwd
from pymodem_tpu.ops import hamming as jham
from pymodem_tpu.synth import modulate as jmod
from pymodem_tpu_torch import config as tcfg
from pymodem_tpu_torch import wav_io as twav
from pymodem_tpu_torch.dsp import window_design as twd
from pymodem_tpu_torch.ops import hamming as tham
from pymodem_tpu_torch.synth import modulate as tmod

# every preset name each builder knows, plus one it does not (the default)
MODEM_PRESETS = {
    "afsk": [*jcfg._AFSK_PRESETS, "other"],
    "afsk_pll": ["300"],
    "bpsk": ["300", "1200", "other"],
    "qpsk": ["600", "2400", "3600", "other"],
    "mpsk": ["qpsk_600", "qpsk_2400", "qpsk_3600", "bpsk_300", "bpsk_1200",
             "other"],
    "fsk": ["9600", "4800", "4800-rrc", "9600-rrc", "4800-gauss",
            "9600-gauss", "other"],
}
SLICER_PRESETS = {
    "binary": [*jcfg._BINARY_SLICER_PRESETS, "1200"],
    "quadrature": [*jcfg._QUAD_SLICER_PRESETS, "other"],
    "4level": ["4800", "9600"],
}


def _same_spec(a, b):
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _lines():
    for modem, names in MODEM_PRESETS.items():
        for name in names:
            yield {"object_name": f"{modem} {name}",
                   "object_type": "demod_chain",
                   "modem": {"type": modem, "config": name,
                             "options": {"carrier_freq": "1510",
                                         "invert": "yes"}},
                   "slicer": {"type": "binary", "config": "300",
                              "options": {"lock_rate": "0.8"}},
                   "stream": {"type": "lfsr",
                              "options": {"poly": "0x63003",
                                          "invert": "yes"}},
                   "codec": {"type": "il2p",
                             "options": {"crc": "no", "sync_tol": "1"}}}
    for slicer, names in SLICER_PRESETS.items():
        for name in names:
            yield {"object_name": f"{slicer} {name}",
                   "object_type": "demod_chain",
                   "modem": {"type": "afsk", "config": "1200"},
                   "slicer": {"type": slicer, "config": name},
                   "codec": {"type": "ax25"}}


def test_config_specs_equal_for_every_preset():
    n = 0
    for line in _lines():
        for rate in (8000.0, 44100.0):
            _same_spec(tcfg.build_chain_spec(rate, line),
                       jcfg.build_chain_spec(rate, line))
            n += 1
    assert n == 2 * (sum(map(len, MODEM_PRESETS.values()))
                     + sum(map(len, SLICER_PRESETS.values())))
    for module in (tcfg, jcfg):
        with pytest.raises(ValueError, match="afsk_pll"):
            module.build_modem_spec(8000.0, {"type": "afsk_pll",
                                             "config": "1200"})


def test_load_plan_equal(tmp_path):
    path = tmp_path / "plan.jsonl"
    path.write_text("\n".join(json.dumps(line) for line in _lines()) + "\n"
                    + json.dumps({"object_name": "r", "object_type":
                                  "report", "options": {"style": "raw"}})
                    + "\n")
    got = tcfg.load_plan(str(path), 44100.0)
    want = jcfg.load_plan(str(path), 44100.0)
    assert len(got.chains) == len(want.chains) == len(list(_lines()))
    for a, b in zip(got.chains + got.reports, want.chains + want.reports):
        _same_spec(a, b)


def test_window_design_equal_bitwise():
    cases = [
        ("bandpass_taps", (131, 200.0, 2800.0, 44100.0, True)),
        ("bandpass_taps", (187, 1500.0, 1900.0, 8000.0)),
        ("lowpass_taps", (67, 240.0, 8000.0)),
        ("tone_correlators", (8000.0, 300.0, 0.3, 1695.0, 1705.0, 0.8,
                              2.0)),
        ("rrc_taps", (44100.0, 1200.0, 6.0, 0.9)),
        ("rrc_taps", (8000.0, 300.0, 6.0, 0.6)),
        ("rrc_taps", (48000.0, 4800.0, 9.0, 0.2, "tukey")),
        ("hilbert_taps", (151,)),
        ("hilbert_taps", (89, "rect")),
        ("nco_wavetable", (256, 1.0)),
        ("iir1_lpf_coefs", (44100.0, 250.0, 1.0)),
        ("qpsk_error_table", (64, 32.0)),
        ("qpsk_error_table", (16, 4.5)),
    ] + [("window_taps", (33, w)) for w in (
        "hann", "rect", "blackmann", "blackmann-harris", "flattop", "tukey")]
    for name, args in cases:
        got, want = getattr(twd, name)(*args), getattr(jwd, name)(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype, name


def test_modulators_equal_sample_for_sample():
    rng = np.random.default_rng(5)
    bits = list(rng.integers(0, 2, 600))
    dibits = list(rng.integers(0, 4, 300))
    cases = [
        ("afsk_modulate", (bits, 8000.0, 300.0, 1600.0, 1800.0)),
        ("fsk_modulate", (bits, 96000.0, 9600.0)),
        ("four_level_modulate", (dibits, 48000.0, 4800.0)),
        ("bpsk_modulate", (bits, 44100.0, 1200.0, 1500.0)),
        ("qpsk_modulate", (bits, 44100.0, 1200.0, 1500.0)),
        ("qpsk_symbols_from_bits", (bits[:-1],)),
    ]
    for name, args in cases:
        got, want = getattr(tmod, name)(*args), getattr(jmod, name)(*args)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    audio = jmod.bpsk_modulate(bits, 44100.0, 1200.0, 1500.0)
    np.testing.assert_array_equal(
        tmod.awgn(audio, 10.0, np.random.default_rng(1)),
        jmod.awgn(audio, 10.0, np.random.default_rng(1)))
    np.testing.assert_array_equal(tmod.to_int16(audio), jmod.to_int16(audio))


def test_hamming_and_wav_io_equal(tmp_path):
    np.testing.assert_array_equal(tham.HAMMING74_DECODE,
                                  jham.HAMMING74_DECODE)
    assert tham.HAMMING74_CODEWORDS == jham.HAMMING74_CODEWORDS
    assert [tham.hamming74_decode(b) for b in range(256)] == \
        [jham.hamming74_decode(b) for b in range(256)]
    data = np.random.default_rng(2).integers(-30000, 30000, 999, np.int16)
    twav.write_wav(str(tmp_path / "a.wav"), 44100, data)
    rate, back = jwav.read_wav(str(tmp_path / "a.wav"))
    assert rate == 44100 and back.dtype == np.int16
    np.testing.assert_array_equal(back, data)
    jwav.write_wav(str(tmp_path / "b.wav"), 8000, data)
    assert twav.read_wav(str(tmp_path / "b.wav"))[0] == 8000


def test_ax25_host_decoder_equal():
    """The re-homed AX.25 deframer gives the JAX package's packets (bytes,
    address, ident) on frames, noise, stuffing and aborts, the byte
    counter's reset past max_packet_length and a short length cap."""
    from pymodem_tpu.codecs.host import ax25_decode_host as jdec
    from pymodem_tpu.synth import encode as jenc
    from pymodem_tpu_torch.codecs.host import ax25_decode_host as tdec

    rng = np.random.default_rng(11)
    bits = []
    for i in range(5):
        bits += [1] * int(rng.integers(1, 12)) + [0] * int(rng.integers(1, 3))
        bits += [int(b) for b in rng.integers(0, 2, 150)]
        payload = bytes(rng.integers(32, 127, 15 + 300 * (i == 2)).astype(
            np.uint8))
        bits += jenc.hdlc_encode(jenc.ax25_ui_frame("KI5ABC", "N0CALL",
                                                    payload), flag_count=2)
    bits += [0] * ((8 - len(bits) % 8) % 8)
    framed = np.array(jenc.bits_to_bytes_msb(bits), np.int64)
    noise = rng.integers(0, 256, 4000).astype(np.int64)
    n = 0
    for data in (framed, noise, np.concatenate([noise, framed])):
        addr = np.arange(len(data), dtype=np.int64) * 3 + 7
        for lo, hi in ((18, 1023), (18, 200), (30, 1023)):
            got, want = (
                [(list(map(int, p.data)), p.streamaddress, p.source_decoder)
                 for p in dec(data, addr, "ax", min_packet_length=lo,
                              max_packet_length=hi)]
                for dec in (tdec, jdec))
            assert got == want
            n += len(want)
    assert n > 10


def test_ax25_encoders_and_fixtures_equal():
    """The AX.25 frame encoders, line coder and chain fixture give the JAX
    package's bits, bytes and audio."""
    from pymodem_tpu.config import build_chain_spec as jbuild
    from pymodem_tpu.synth import encode as jenc
    from pymodem_tpu.synth import fixtures as jfx
    from pymodem_tpu_torch.synth import encode as tenc
    from pymodem_tpu_torch.synth import fixtures as tfx

    frame = ([0x7E, 0xFF, 0x00, 0x1F] * 9)[:30]
    assert tenc.bytes_to_bits_lsb(frame) == jenc.bytes_to_bits_lsb(frame)
    assert tenc.ax25_address_field("KI5ABC", "N0", 3, 12) == \
        jenc.ax25_address_field("KI5ABC", "N0", 3, 12)
    assert tenc.ax25_ui_frame("AB1CDE", "FG2HIJ", b"hello\xff", 0xCF) == \
        jenc.ax25_ui_frame("AB1CDE", "FG2HIJ", b"hello\xff", 0xCF)
    for flags in (1, 4):
        assert tenc.hdlc_encode(frame, flags) == jenc.hdlc_encode(frame,
                                                                  flags)
    payloads = [b"0123456789", b"\xff" * 12]
    for poly, invert in ((0x3, True), (0x63003, False)):
        assert tfx.ax25_line_bits(payloads, poly, invert, 50) == \
            jfx.ax25_line_bits(payloads, poly, invert, 50)
    line = {"object_name": "a", "object_type": "demod_chain",
            "modem": {"type": "afsk", "config": "1200"},
            "slicer": {"type": "binary", "config": "1200"},
            "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                                   "invert": "yes"}},
            "codec": {"type": "ax25"}}
    for rate in (8000.0, 44100.0):
        got = tfx.synthesize_for_chain(tcfg.build_chain_spec(rate, line),
                                       rate, np.random.default_rng(4),
                                       n_frames=2, size=12, gap_bits=100)
        want = jfx.synthesize_for_chain(jbuild(rate, line), rate,
                                        np.random.default_rng(4),
                                        n_frames=2, size=12, gap_bits=100)
        assert got[0] == want[0]
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(want[1]))
