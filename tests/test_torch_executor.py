"""The port's sequential executor against pymodem_tpu's, and the resilient
retry of the banked runtime.

One chain per family, each on synthesized audio at the preset's own rate
(AFSK-300 correlator and PLL at 8 kHz; BPSK-1200, Costas QPSK-2400 and
MPSK QPSK-2400 at 44.1 kHz; FSK-9600 at 96 kHz; 4FSK at 48 kHz), and
AFSK-1200 AX.25 at 8 kHz and at 44.1 kHz, float32 on both sides:

* ``run_plan``: packets (payload, CRC, stream address, corrections) and
  report text equal to the JAX package's ``run_plan`` on its default FIR
  method (an FFT convolution in f32), every frame decoded, none rejected;
* float stages against the JAX package's ``method="direct"``: each FIR of
  t taps within 2 sqrt(t) ulps of the sum of its terms' magnitudes (an
  f32 sum in another order; 11 seen at ~200 taps, 4 at 9), the AGC
  bitwise; whole basebands agree in sign on at least 99% of samples.
  The carrier loops part from XLA's scans after a few samples, because
  XLA:CPU fuses some multiply-adds into FMAs and the loop's feedback
  carries the last bit (tests/test_torch_loops.py shows the cause); their
  decisions are held by the packets;
* integer stages (the slicer at one lane and compaction) bitwise on the
  same baseband.

The port runs its kernels' plain twins here.
"""

import json
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymodem_tpu import modems as jmodems
from pymodem_tpu.config import RunPlan as JRunPlan
from pymodem_tpu.config import build_chain_spec as jbuild_chain_spec
from pymodem_tpu.dsp.fir import fir_valid as jfir_valid
from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu.runtime import executor as jexecutor
from pymodem_tpu_torch import modems as tmodems
from pymodem_tpu_torch.config import ReportSpec, RunPlan, build_chain_spec
from pymodem_tpu_torch.config import load_plan
from pymodem_tpu_torch.convert import chain_params_from_jax
from pymodem_tpu_torch.dsp.fir import fir_valid_nd
from pymodem_tpu_torch.runtime import executor as texecutor
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

REPORTS = (ReportSpec("decoded", style="decoded_headers"),
           ReportSpec("raw", style="raw"))


def _line(modem, preset, slicer, slicer_preset, poly="0x3", invert="no",
          codec="il2p"):
    return {
        "object_name": f"{modem} {preset}", "object_type": "demod_chain",
        "modem": {"type": modem, "config": preset, "options": {}},
        "slicer": {"type": slicer, "config": slicer_preset, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": poly,
                                               "invert": invert}},
        "codec": {"type": codec, "options": {"crc": "yes"}},
    }


# family -> (config line, sample rate)
FAMILIES = {
    "afsk300": (_line("afsk", "300", "binary", "300"), 8000.0),
    "afsk300_pll": (_line("afsk_pll", "300", "binary", "300"), 8000.0),
    "bpsk1200": (_line("bpsk", "1200", "binary", "1200"), 44100.0),
    "qpsk2400_costas": (_line("qpsk", "2400", "quadrature", "qpsk_2400",
                              "0x1"), 44100.0),
    "mpsk_qpsk2400": (_line("mpsk", "qpsk_2400", "quadrature", "qpsk_2400",
                            "0x1"), 44100.0),
    "fsk9600": (_line("fsk", "9600", "binary", "9600", "0x63003"),
                96000.0),
    "fsk4_9600": (_line("fsk", "4800", "4level", "4800", "0x1"), 48000.0),
    "afsk1200_ax25": (_line("afsk", "1200", "binary", "1200", "0x3", "yes",
                            "ax25"), 8000.0),
}
COHERENT = ("afsk300_pll", "bpsk1200", "qpsk2400_costas", "mpsk_qpsk2400")


def _chains(family):
    line, rate = FAMILIES[family]
    return build_chain_spec(rate, line), jbuild_chain_spec(rate, line)


_AUDIO: dict = {}


def _audio(family):
    """(payloads sent, int16 audio): 2 frames of 10 bytes 300 idle bits
    apart, line-coded per the chain; the AFSK-300 correlator's on
    1600/1800 Hz tones, which the "300" preset decodes from any phase."""
    if family not in _AUDIO:
        chain, _ = _chains(family)
        rate = FAMILIES[family][1]
        rng = np.random.default_rng(20261102)
        if family == "afsk300":
            sent = tfx.payloads(rng, count=2, size=10)
            x = tmod.afsk_modulate(tfx.il2p_line_bits(sent, gap_bits=300),
                                   rate, 300.0, 1600.0, 1800.0)
        else:
            sent, x = tfx.synthesize_for_chain(chain, rate, rng, n_frames=2,
                                               size=10, gap_bits=300)
        _AUDIO[family] = (sent, tmod.to_int16(x))
    return _AUDIO[family]


def _packets(aggregate):
    return [[(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
              int(p.streamaddress), int(p.bytes_corrected)) for p in chain]
            for chain in aggregate.chains]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_plan_matches_jax(family):
    chain, jchain = _chains(family)
    rate = FAMILIES[family][1]
    sent, x = _audio(family)
    got = texecutor.run_plan(RunPlan(chains=(chain,), reports=REPORTS), x,
                             rate, resilient=False, device="cpu")
    want = jexecutor.run_plan(JRunPlan(chains=(jchain,), reports=REPORTS),
                              x, rate, dtype=jnp.float32, resilient=False)
    assert _packets(got.aggregate) == _packets(want.aggregate)
    assert got.reports == want.reports
    assert f"Unique, valid packets:  {len(sent)}\n" in got.reports[0]
    assert got.aggregate.count_bad() == 0
    assert sorted(bytes(p.data[16:-2]) for p in got.aggregate.unique) == \
        sorted(sent)


def test_ax25_run_plan_at_44k_matches_jax():
    """AFSK-1200 AX.25 at 44.1 kHz, the rate of its sweep on the card:
    packets and report text equal to the JAX package's run_plan, every
    frame decoded.  At this rate both packages also report one frame with
    a bad CRC: a false flag in the alternating idle bits ahead of the first
    frame while the slicer acquires, closed 37 bytes of 0x55 later (the
    idle fill is not HDLC flags); it is held equal too."""
    line, _ = FAMILIES["afsk1200_ax25"]
    rate = 44100.0
    chain, jchain = build_chain_spec(rate, line), jbuild_chain_spec(rate,
                                                                   line)
    rng = np.random.default_rng(20261102)
    sent, x = tfx.synthesize_for_chain(chain, rate, rng, n_frames=2,
                                       size=10, gap_bits=300)
    x = tmod.to_int16(x)
    got = texecutor.run_plan(RunPlan(chains=(chain,), reports=REPORTS), x,
                             rate, resilient=False, device="cpu")
    want = jexecutor.run_plan(JRunPlan(chains=(jchain,), reports=REPORTS),
                              x, rate, dtype=jnp.float32, resilient=False)
    assert _packets(got.aggregate) == _packets(want.aggregate)
    assert got.reports == want.reports
    assert f"Unique, valid packets:  {len(sent)}\n" in got.reports[0]
    assert sorted(bytes(p.data[16:-2]) for p in got.aggregate.unique) == \
        sorted(sent)
    bad = [bytes(p.data) for chain_ in got.aggregate.chains for p in chain_
           if not (p.valid_crc and p.valid_header)]
    assert got.aggregate.count_bad() == want.aggregate.count_bad() == 1
    assert bad == [b"\x55" * 37]


def _fir_taps(params) -> dict:
    """Every FIR tap set of a family's parameters."""
    names = ("input_bpf", "input_lpf", "output_lpf", "rrc", "hilbert",
             "mark_i", "mark_q", "space_i", "space_q")
    return {k: getattr(params, k) for k in names if hasattr(params, k)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fir_stages_within_ulps(family):
    """Each FIR of the family over its own float32 audio: the port's
    engine against the JAX package's ``direct`` convolution, within
    2 sqrt(t) ulps of the sum of the t terms' magnitudes."""
    chain, jchain = _chains(family)
    x = _audio(family)[1].astype(np.float32)
    for name, taps in _fir_taps(jmodems.build_params(jchain.modem)).items():
        want = np.asarray(jfir_valid(jnp.asarray(x), jnp.asarray(
            taps, jnp.float32), "direct"))
        got = fir_valid_nd(torch.from_numpy(x), taps).numpy()
        mag = np.convolve(np.abs(x).astype(np.float64), np.abs(
            taps.astype(np.float32)).astype(np.float64), "valid")
        err = np.abs(got.astype(np.float64) - want)
        ulps = float((err / np.spacing(mag.astype(np.float32))).max())
        assert ulps <= 2.0 * np.sqrt(len(taps)), (name, len(taps), ulps)


@pytest.mark.parametrize("family", COHERENT)
def test_agc_stage_bitwise(family):
    """The AGC over the whole band-passed recording (normal: its signed
    max): the port's (kernel K4's twin at one lane) equals the JAX
    package's ``_apply_agc`` bitwise, on the same input."""
    _, jchain = _chains(family)
    jparams = jmodems.build_params(jchain.modem)
    x = _audio(family)[1]
    xf = jfir_valid(jnp.asarray(x, jnp.float32),
                    jnp.asarray(jparams.input_bpf, jnp.float32), "direct")
    want = np.asarray(jmodems._apply_agc(xf, jparams.agc))
    got = tmodems._apply_agc(torch.from_numpy(np.array(xf)),
                             chain_params_from_jax(jparams).agc)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_demod_decisions_match_jax(family):
    """Whole-recording basebands from the same parameters
    (``chain_params_from_jax``): finite, of the JAX package's shape, and of
    the same sign on at least 99% of samples (the carrier loops part from
    XLA's scans by FMA roundings, module docstring)."""
    chain, jchain = _chains(family)
    x = _audio(family)[1]
    jparams = jmodems.build_params(jchain.modem)
    want = jmodems.demod(jchain.modem, jparams, jnp.asarray(x, jnp.float32),
                         "direct")
    got = tmodems.demod(chain.modem, chain_params_from_jax(jparams),
                        torch.from_numpy(x).to(torch.float32))
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        w = np.asarray(w)
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert np.mean(np.sign(g.numpy()) == np.sign(w)) >= 0.99


@pytest.mark.parametrize("family", ["afsk1200_ax25", "qpsk2400_costas",
                                    "fsk4_9600"])
def test_run_slicer_matches_jax(family):
    """Binary, quadrature and four-level slicing at one lane and the
    compaction: bytes, addresses and count bitwise equal to the JAX
    package's ``run_slicer`` on the same (the JAX package's) baseband."""
    chain, jchain = _chains(family)
    x = _audio(family)[1]
    jparams = jmodems.build_params(jchain.modem)
    base = jmodems.demod(jchain.modem, jparams, jnp.asarray(x, jnp.float32))
    want = jexecutor.run_slicer(jchain.slicer, base)
    tbase = (tuple(torch.from_numpy(np.asarray(b)) for b in base)
             if isinstance(base, tuple) else torch.from_numpy(np.asarray(base)))
    got = texecutor.run_slicer(chain.slicer, tbase)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_chain_params_from_jax(family):
    """convert.chain_params_from_jax gives the port's own build_params,
    leaf for leaf (the f64 detector table of mpsk dropped)."""
    chain, jchain = _chains(family)
    got = chain_params_from_jax(jmodems.build_params(jchain.modem))
    want = tmodems.build_params(chain.modem)
    assert type(got) is type(want)
    for a, b in zip(got, want):
        if hasattr(a, "_fields"):
            assert type(a) is type(b)
            a, b = tuple(a), tuple(b)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("up", [2, 3])
def test_upsample_poly_matches_scipy(up):
    """The AFSK output-oversample stage over a whole recording equals
    scipy.signal.resample_poly(x, up, 1) (the reference's, afsk.py:
    164-165): in float64 to 1e-12 of the peak, in float32 within 2 sqrt(t)
    ulps of the sum of the t terms' magnitudes."""
    from scipy.signal import resample_poly

    x = np.random.default_rng(up).standard_normal(3001)
    taps = tmodems._resample_poly_taps(up)
    want = resample_poly(x, up, 1)
    got = tmodems._upsample_poly(torch.from_numpy(x), taps, up).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    got32 = tmodems._upsample_poly(torch.from_numpy(x.astype(np.float32)),
                                   taps, up).numpy()
    stuffed = np.zeros(len(x) * up)
    stuffed[::up] = np.abs(x.astype(np.float32))
    half = (len(taps) - 1) // 2
    mag = np.convolve(np.pad(stuffed, half), np.abs(
        taps.astype(np.float32)).astype(np.float64), "valid")
    ulps = np.abs(got32 - want) / np.spacing(mag.astype(np.float32))
    assert ulps.max() <= 2.0 * np.sqrt(len(taps)), ulps.max()


def test_slice_capacity_matches_jax():
    for args in ((80000, 26.67, 1), (5_000_000, 10.0, 2), (7, 3.5, 1)):
        assert texecutor._slice_capacity(*args) == \
            jexecutor._slice_capacity(*args)


# ---------------------------------------------------------------------------
# Resilience (tests/test_resilience.py, on the port)
# ---------------------------------------------------------------------------


def _two_chain_plan(tmp_path):
    chain = {
        "object_name": "good", "object_type": "demod_chain",
        "modem": {"type": "afsk", "config": "1200", "options": {}},
        "slicer": {"type": "binary", "config": "1200", "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                               "invert": "no"}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }
    bad = dict(chain, object_name="bad")
    report = {
        "object_name": "report", "object_type": "report",
        "options": {"style": "decoded_headers", "destination": "std_out"},
    }
    cfg = tmp_path / "two.json"
    cfg.write_text("\n".join(json.dumps(o) for o in (bad, chain, report)))
    return load_plan(str(cfg), 8000.0)


def _resilience_audio():
    rng = np.random.default_rng(5)
    sent = tfx.payloads(rng, count=2, size=25)
    line = tfx.il2p_line_bits(sent, polynomial=0x3, invert=False)
    return tmod.to_int16(
        tmod.afsk_modulate(line, 8000.0, 1200.0, 1200.0, 2200.0))


def _fail_chain_named(monkeypatch, name, devices=None):
    real = texecutor.run_chain

    def flaky(spec, audio, **kw):
        if devices is not None:
            devices.append(kw.get("device"))
        if spec.name == name:
            raise RuntimeError("injected device failure")
        return real(spec, audio, **kw)

    monkeypatch.setattr(texecutor, "run_chain", flaky)


def test_sequential_plan_skips_failed_chain(tmp_path, monkeypatch, capsys):
    plan = _two_chain_plan(tmp_path)
    _fail_chain_named(monkeypatch, "bad")
    result = texecutor.run_plan(plan, _resilience_audio(), 8000.0,
                                device="cpu")
    out = capsys.readouterr().out
    assert "skipped chain bad: RuntimeError: injected device failure" in out
    # the surviving chain still decodes both packets
    assert sum(1 for p in result.aggregate.unique if p.valid_crc) == 2

    with pytest.raises(RuntimeError):
        texecutor.run_plan(plan, _resilience_audio(), 8000.0,
                           resilient=False, device="cpu")


def test_banked_plan_falls_back_and_skips(tmp_path, monkeypatch, capsys):
    """A failing bank is retried chain by chain through the executor on
    the device the caller named, with the JAX package's messages."""
    from pymodem_tpu_torch.runtime import bank

    plan = _two_chain_plan(tmp_path)

    def broken_bank(*a, **kw):
        raise RuntimeError("injected bank failure")

    monkeypatch.setattr(bank, "run_banked", broken_bank)
    devices = []
    _fail_chain_named(monkeypatch, "bad", devices)
    result = bank.run_plan_banked(plan, _resilience_audio(), 8000.0,
                                  device="cpu")
    out = capsys.readouterr().out
    assert ("banked runtime failed (RuntimeError: injected bank failure); "
            "retrying chains sequentially") in out
    assert "skipped chain bad: RuntimeError: injected device failure" in out
    assert sum(1 for p in result.aggregate.unique if p.valid_crc) == 2
    assert devices == ["cpu", "cpu"]

    with pytest.raises(RuntimeError):
        bank.run_plan_banked(plan, _resilience_audio(), 8000.0,
                             resilient=False, device="cpu")


def test_banked_many_retries_recordings(tmp_path, monkeypatch, capsys):
    """run_plan_banked_many: a failure of the pipelined run retries each
    recording through run_plan_banked (whose bank fails too, so its chains
    go through the executor); resilient=False raises."""
    from pymodem_tpu_torch.runtime import bank

    plan = _two_chain_plan(tmp_path)
    plan = replace(plan, chains=plan.chains[1:])  # the good chain only

    def broken(*a, **kw):
        raise RuntimeError("injected bank failure")

    monkeypatch.setattr(bank, "run_banked_many", broken)
    monkeypatch.setattr(bank, "run_banked", broken)
    audio = _resilience_audio()
    results = bank.run_plan_banked_many(plan, [audio, audio], 8000.0,
                                        device="cpu")
    out = capsys.readouterr().out
    assert ("banked runtime failed (RuntimeError: injected bank failure); "
            "retrying recordings individually") in out
    assert [sum(p.valid_crc for p in r.aggregate.unique)
            for r in results] == [2, 2]
    with pytest.raises(RuntimeError):
        bank.run_plan_banked_many(plan, [audio], 8000.0, resilient=False,
                                  device="cpu")


@pytest.mark.parametrize("runtime", ["banked", "sequential"])
def test_lost_device_is_not_retried(tmp_path, monkeypatch, capsys, runtime):
    """After a failure that left the device lost (a sticky CUDA error,
    ``device.lost``) no retry can run: the runtime names the error once
    and raises DeviceLostError, and the CLI exits 1 without a report."""
    from pymodem_tpu_torch import cli, device
    from pymodem_tpu_torch.runtime import bank
    from pymodem_tpu_torch.wav_io import write_wav

    sticky = "AcceleratorError: CUDA error: device-side assert triggered"
    plan = _two_chain_plan(tmp_path)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(bank, "run_banked", broken)
    monkeypatch.setattr(texecutor, "run_chain", broken)
    monkeypatch.setattr(device, "lost", lambda dev: sticky)
    run_plan = (bank.run_plan_banked if runtime == "banked"
                else texecutor.run_plan)
    with pytest.raises(device.DeviceLostError, match="device-side assert"):
        run_plan(plan, _resilience_audio(), 8000.0, device="cpu")
    out = capsys.readouterr().out
    assert out.count(sticky) == 1 and "the device is lost, no retry" in out
    assert "skipped chain" not in out and "retrying" not in out

    cfg = tmp_path / "two.json"
    wav = tmp_path / "x.wav"
    write_wav(str(wav), 8000, _resilience_audio())
    monkeypatch.setenv("PYMODEM_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PYMODEM_TPU_TORCH_RUNTIME", runtime)
    assert cli.run_decode(str(cfg), str(wav)) == 1
    out = capsys.readouterr().out
    assert out.count(sticky) == 1 and "Generating" not in out
