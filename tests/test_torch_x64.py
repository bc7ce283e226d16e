"""The port's float64 parity mode on the CPU, against pymodem_tpu at x64.

The JAX side runs with ``jax_enable_x64`` on (tests/conftest.py) and
``dtype=jnp.float64``, its reference-parity mode; the port runs
``dtype=torch.float64`` on the CPU, through the plain twins of its f64
kernels (K10 binary slicer, K11 AGC + AFSK PLL / BPSK Costas loop, K12
four-level slicer), whose bitwise equality with the kernels is held on
the card (tests/test_torch_cuda.py, chip_smoke.py):

* the sequential executor (the mode's default route): packets and report
  text equal to the JAX package's ``run_plan`` for the ``afsk``,
  ``afsk_pll``, ``bpsk``, ``fsk`` (binary slicer) and 4FSK families;
* the banked runtime: ``run_plan_banked(dtype=float64)`` on a 3-chain
  AFSK space-gain sweep (demodulated per chain at f64, no ``space_scale``
  row) and the PLL pair (``pre_shared``), packets and report text equal;
* the FIRs at f64 against the JAX package's ``direct`` engine, to 1e-12
  of the peak (the CPU's ``conv1d``, and the banded DGEMM engine the card
  runs at f64);
* the slicers' twins at f64 against the JAX f64 scans, compacted, bitwise;
* the CLI under ``PYMODEM_TPU_TORCH_X64=1`` and ``PYMODEM_TPU_X64=1``;
* what is not yet ported at f64 raises: a ``qpsk`` or ``mpsk`` chain on
  the card, the multi-recording entry points and the stream.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymodem_tpu.config import RunPlan as JRunPlan
from pymodem_tpu.config import build_chain_spec as jbuild_chain_spec
from pymodem_tpu.dsp import fir as jfir
from pymodem_tpu.dsp import loops as jloops
from pymodem_tpu.ops import slicers as jsl
from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu.runtime import executor as jexecutor
from pymodem_tpu_torch import cli as tcli
from pymodem_tpu_torch import modems as tmodems
from pymodem_tpu_torch.config import ReportSpec, RunPlan, build_chain_spec
from pymodem_tpu_torch.convert import bank_params_from_jax
from pymodem_tpu_torch.device import resolve_dtype
from pymodem_tpu_torch.dsp import fir as tfir
from pymodem_tpu_torch.dsp import loops as tloops
from pymodem_tpu_torch.dsp import window_design as wd
from pymodem_tpu_torch.mode import X64_VAR
from pymodem_tpu_torch.ops import slicers as tsl
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.runtime import executor as texecutor
from pymodem_tpu_torch.runtime.stream import StreamDecoder
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
REPORTS = (ReportSpec("decoded", style="decoded_headers"),
           ReportSpec("raw", style="raw"))


def _line(modem, preset, slicer, slicer_preset, poly="0x3", invert="no",
          name=None):
    return {
        "object_name": name or f"{modem} {preset}",
        "object_type": "demod_chain",
        "modem": {"type": modem, "config": preset, "options": {}},
        "slicer": {"type": slicer, "config": slicer_preset, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": poly,
                                               "invert": invert}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }


# the families of the f64 mode on the card, each at its preset's own rate
FAMILIES = {
    "afsk300": (_line("afsk", "300", "binary", "300"), 8000.0),
    "afsk300_pll": (_line("afsk_pll", "300", "binary", "300"), 8000.0),
    "bpsk1200": (_line("bpsk", "1200", "binary", "1200"), 44100.0),
    "fsk9600": (_line("fsk", "9600", "binary", "9600", "0x63003"),
                96000.0),
    "fsk4_9600": (_line("fsk", "4800", "4level", "4800", "0x1"), 48000.0),
}
_AUDIO: dict = {}


def _audio(family):
    """(payloads, int16 audio): 2 frames of 10 bytes 300 idle bits apart,
    line-coded per the chain (1-2 s: the twins step in Python); the
    AFSK-300 correlator's on 1600/1800 Hz tones, which the "300" preset
    decodes from any phase."""
    if family not in _AUDIO:
        line, rate = FAMILIES[family]
        chain = build_chain_spec(rate, line)
        rng = np.random.default_rng(20261117)
        if family == "afsk300":
            sent = tfx.payloads(rng, count=2, size=10)
            x = tmod.afsk_modulate(tfx.il2p_line_bits(sent, gap_bits=300),
                                   rate, 300.0, 1600.0, 1800.0)
        else:
            sent, x = tfx.synthesize_for_chain(chain, rate, rng, n_frames=2,
                                               size=10, gap_bits=300)
        _AUDIO[family] = (sent, tmod.to_int16(x))
    return _AUDIO[family]


def _packets(chains):
    return [[(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
              int(p.streamaddress), int(p.bytes_corrected)) for p in chain]
            for chain in chains]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_plan_f64_matches_jax(family):
    """The executor at f64: packets and report text equal to the JAX
    package's f64 run_plan, every frame decoded, none rejected."""
    line, rate = FAMILIES[family]
    sent, x = _audio(family)
    got = texecutor.run_plan(
        RunPlan(chains=(build_chain_spec(rate, line),), reports=REPORTS), x,
        rate, resilient=False, device="cpu", dtype=F64)
    want = jexecutor.run_plan(
        JRunPlan(chains=(jbuild_chain_spec(rate, line),), reports=REPORTS),
        x, rate, dtype=jnp.float64, resilient=False)
    assert _packets(got.aggregate.chains) == _packets(want.aggregate.chains)
    assert got.reports == want.reports
    assert f"Unique, valid packets:  {len(sent)}\n" in got.reports[0]
    assert got.aggregate.count_bad() == 0


def test_run_chain_takes_the_modes_dtype(monkeypatch):
    """dtype=None is the mode's: float64 under PYMODEM_TPU_TORCH_X64, as
    the JAX package's None under jax_enable_x64."""
    line, rate = FAMILIES["fsk9600"]
    chain = build_chain_spec(rate, line)
    _, x = _audio("fsk9600")
    monkeypatch.setenv(X64_VAR, "1")
    assert resolve_dtype(None) == F64
    by_mode = texecutor.run_chain(chain, x, device="cpu")
    assert _packets([by_mode]) == _packets(
        [texecutor.run_chain(chain, x, device="cpu", dtype=F64)])
    for off in ("0", "", "false"):
        monkeypatch.setenv(X64_VAR, off)
        assert resolve_dtype(None) == torch.float32


def test_f64_without_a_gpu_raises():
    """No fallback: an f64 run on the default device, the card, raises
    without a GPU; the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    line, rate = FAMILIES["fsk9600"]
    _, x = _audio("fsk9600")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        texecutor.run_chain(build_chain_spec(rate, line), x, dtype=F64)


# ---------------------------------------------------------------------------
# the banked runtime at f64
# ---------------------------------------------------------------------------

BANK_RATE = 8000.0
GEOM = dict(block_seconds=2.0, overlap_seconds=2.5)


def _sweep(build):
    """A 3-chain AFSK-300 space-gain sweep (gains 0.9, 1.0, 1.1), each
    package's specs from its own ``build_chain_spec``."""
    base = build(BANK_RATE, _line("afsk", "300", "binary", "300",
                                  name="AFSK 300 Il2Pc Correlator"))
    return [replace(base, name=f"s{i}",
                    modem=replace(base.modem, space_gain=0.9 + 0.1 * i))
            for i in range(3)]


def _pair(build):
    """The afsk_300_pll-style pair: one PLL chain per descrambler invert."""
    return [build(BANK_RATE, _line("afsk_pll", "300", "binary", "300",
                                   invert=inv,
                                   name=f"AFSK 300 Il2Pc PLL {inv}"))
            for inv in ("no", "yes")]


SWEEP, PAIR = _sweep(build_chain_spec), _pair(build_chain_spec)


def _bank_audio():
    """3 IL2P+CRC frames on 1600/1800 Hz tones, ~6 s at 8 kHz."""
    rng = np.random.default_rng(20261117)
    sent = tfx.payloads(rng, count=3, size=10)
    line = tfx.il2p_line_bits(sent, polynomial=0x3, gap_bits=300)
    return sent, tmod.to_int16(tmod.afsk_modulate(line, BANK_RATE, 300.0,
                                                  1600.0, 1800.0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("which", ["sweep", "pll_pair"])
def test_group_chains_f64_matches_jax(which):
    """The f64 bank's leaves equal the JAX package's f64 bank leaf for
    leaf: float64, no space_scale row on the sweep, pre_shared on the
    carrier pair; the NCO tables are the reference wavetable and its
    quarter-turn shift."""
    make = _sweep if which == "sweep" else _pair
    chains = make(build_chain_spec)
    (jb,) = jbank.group_chains(make(jbuild_chain_spec), jnp.float64)
    (tb,) = tbank.group_chains(chains, "cpu", dtype=F64)
    assert tb.dtype == F64
    want = _flat(bank_params_from_jax(jb.params, device="cpu"))
    got = _flat(tb.params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert "space_scale" not in tb.params
    assert got["sps/"].dtype == F64
    assert ("pre_shared" in tb.params) == (which == "pll_pair")
    if which == "pll_pair":
        table = wd.nco_wavetable(256, 1.0)
        assert np.array_equal(tb.params["sine_table"].numpy(), table)
        assert np.array_equal(tb.params["cos_table"].numpy(),
                              table[(np.arange(256) + 64) % 256])
    # at f32 the same sweep carries its scale row
    if which == "sweep":
        assert "space_scale" in tbank.group_chains(chains, "cpu")[0].params


def test_run_plan_banked_f64_matches_jax():
    """run_plan_banked at f64 (the device codec, the default route of
    both): packets and report text equal to the JAX package's at x64,
    every frame decoded by the unity-gain chain and by the PLL chain whose
    descrambler matches the audio's."""
    sent, x = _bank_audio()
    reports = (ReportSpec("decoded", style="decoded_headers"),)
    chains = tuple(SWEEP + PAIR)
    jchains = tuple(_sweep(jbuild_chain_spec) + _pair(jbuild_chain_spec))
    want = jbank.run_plan_banked(JRunPlan(chains=jchains, reports=reports),
                                 x, BANK_RATE, dtype=jnp.float64,
                                 resilient=False, **GEOM)
    got = tbank.run_plan_banked(RunPlan(chains=chains, reports=reports), x,
                                BANK_RATE, resilient=False, device="cpu",
                                dtype=F64, **GEOM)
    assert _packets(got.aggregate.chains) == _packets(want.aggregate.chains)
    assert got.reports == want.reports
    assert f"Unique, valid packets:  {len(sent)}\n" in got.reports[0]
    assert got.aggregate.count_bad() == 0
    by_chain = dict(zip([c.name for c in chains], got.aggregate.chains))
    for name in ("s1", PAIR[0].name):  # the audio's descrambler invert
        assert sorted(bytes(p.data[16:-2]) for p in by_chain[name]) == \
            sorted(sent), name


# ---------------------------------------------------------------------------
# FIRs, loops and slicers at f64
# ---------------------------------------------------------------------------


def _direct(x, taps):
    return np.asarray(jfir.fir_valid_nd(jnp.asarray(x), jnp.asarray(taps),
                                        "direct"))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n_taps", [7, 133])
def test_fir_f64_matches_jax_direct(n_taps, rng):
    """Each FIR entry point at f64 on the CPU (``conv1d``), and the banded
    DGEMM engine that the card runs at f64, within 1e-12 of the peak of
    the JAX package's direct convolution."""
    x = rng.standard_normal((3, 2, 2000))
    taps = rng.standard_normal((2, n_taps))
    xt, tt = torch.from_numpy(x), torch.from_numpy(taps)
    assert tfir._method(xt, n_taps) == "direct"
    assert tfir._method(xt.to("meta"), n_taps) == "matmul"
    want = _direct(x, taps[0])
    _close(tfir.fir_valid_nd(xt, taps[0]), want)
    y, n_tiles, nout = tfir._matmul(xt, tfir._band(tt[0]), n_taps)
    _close(y.reshape(3, 2, n_tiles * 128)[..., :nout], want)
    got = tfir.fir_valid_multi(xt, taps)
    for k in range(2):
        _close(got[k], _direct(x, taps[k]))
    got = tfir.fir_valid_per_chain(xt[:2], taps)
    for c in range(2):
        _close(got[c], _direct(x[c], taps[c]))


def _slicer_input(rng, n_lanes, n):
    sps = 8000.0 / 300.0
    idx = (np.arange(n) / sps).astype(np.int64)
    sym = rng.integers(0, 4, (n_lanes, idx.max() + 2)) * 2.0 - 3.0
    return sym[:, idx] + 0.3 * rng.standard_normal((n_lanes, n)), sps


@pytest.mark.parametrize("kind", ["binary", "4level"])
def test_slicer_twins_f64_match_jax_scans(kind, rng):
    """The twins of K10 and K12 at f64, compacted as the bank compacts
    them (windowed emissions), equal the JAX f64 scans' compact_bytes
    bitwise: bytes, addresses and counts."""
    x, sps = _slicer_input(rng, 3, 6000)
    lock, demap = 0.75, (2, 0, 3, 1)
    bps = 1 if kind == "binary" else 2
    window = tsl.safe_compact_window(sps, lock, bps)
    rows = torch.tensor([[sps] * 3, [lock] * 3], dtype=F64)
    xt = torch.from_numpy(x)
    if kind == "binary":
        enc = tsl.binary_slice_lanes(xt, rows, window)
    else:
        enc = tsl.four_level_slice_lanes(xt, rows, demap, window)
    cap = 512
    got = tsl.compact_windowed(enc, window, cap)
    for lane in range(3):
        xl = jnp.asarray(x[lane])
        if kind == "binary":
            out = jsl.binary_slice(xl, sps, lock)
        else:
            out = jsl.four_level_slice(xl, sps, lock,
                                       jnp.asarray(demap, jnp.int32), 0.0)
        want = jsl.compact_bytes(out, cap, window)
        assert int(want[2]) > 10
        for g, w in zip(got, want):
            assert np.array_equal(g[lane].numpy(), np.asarray(w)), lane


def test_bpsk_twin_f64_matches_scan():
    """K11's bpsk twin at f64, with the reference wavetable and its
    quarter-turn shift as the two tables, against the JAX package's AGC
    then f64 Costas scan on the same band-passed input: to 1e-12 of the
    peak.  (The afsk_pll kind: tests/test_torch_loops.py.)"""
    from pymodem_tpu import modems as jmodems

    spec = build_chain_spec(44100.0, FAMILIES["bpsk1200"][0]).modem
    _, x16 = _audio("bpsk1200")
    jparams = jmodems.bpsk_params(spec)
    filtered = jfir.fir_valid(jnp.asarray(x16[:8000], jnp.float64),
                              jnp.asarray(jparams.input_bpf), "direct")
    want = np.asarray(jloops.bpsk_costas(
        jmodems._apply_agc(filtered, jparams.agc),
        jmodems._loop_params(spec, jnp.float64)))
    x = torch.from_numpy(np.array(filtered))
    rows = torch.cat([tmodems._loop_rows(spec, F64),
                      tmodems.agc_rows(tmodems.bpsk_params(spec).agc, x)])
    got = tloops.bpsk_costas_lanes(x[None], rows.contiguous(),
                                   *tmodems.nco_tables("cpu", F64))[0]
    _close(got, want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(module, *args, env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def _report(stdout: str) -> str:
    return stdout[stdout.index("Generating"):stdout.index("Elapsed time")]


def test_runtime_name_under_x64(monkeypatch):
    monkeypatch.delenv("PYMODEM_TPU_TORCH_RUNTIME", raising=False)
    monkeypatch.delenv(X64_VAR, raising=False)
    assert tcli.runtime_name() == "banked"
    monkeypatch.setenv(X64_VAR, "1")
    assert tcli.runtime_name() == "sequential"
    monkeypatch.setenv("PYMODEM_TPU_TORCH_RUNTIME", "banked")
    assert tcli.runtime_name() == "banked"
    monkeypatch.delenv("PYMODEM_TPU_TORCH_RUNTIME")
    monkeypatch.setenv(X64_VAR, "false")
    assert tcli.runtime_name() == "banked"


def test_cli_x64_matches_jax(tmp_path):
    """``PYMODEM_TPU_TORCH_X64=1 PYMODEM_TPU_TORCH_DEVICE=cpu`` against
    ``PYMODEM_TPU_X64=1``: the same exit code and report text on an
    AFSK-300 PLL config, every frame decoded."""
    from scipy.io import wavfile

    sent, x = _audio("afsk300_pll")
    wav = tmp_path / "pll.wav"
    wavfile.write(str(wav), 8000, x)
    cfg = tmp_path / "pll.json"
    cfg.write_text("".join(json.dumps(d) + "\n" for d in (
        FAMILIES["afsk300_pll"][0],
        {"object_name": "report", "object_type": "report",
         "options": {"style": "decoded_headers", "destination": "std_out"}})))
    port = _cli("pymodem_tpu_torch", str(cfg), str(wav),
                env_extra={X64_VAR: "1", "PYMODEM_TPU_TORCH_DEVICE": "cpu"})
    ref = _cli("pymodem_tpu", str(cfg), str(wav),
               env_extra={"PYMODEM_TPU_X64": "1"})
    assert port.returncode == ref.returncode == 0, port.stderr[-2000:]
    assert f"Unique, valid packets:  {len(sent)}\n" in port.stdout
    assert _report(port.stdout) == _report(ref.stdout)
    assert "banked runtime" not in port.stdout  # the sequential executor


# ---------------------------------------------------------------------------
# not yet ported at f64
# ---------------------------------------------------------------------------


def test_f64_kernel_check_refuses_qpsk_and_mpsk_on_the_card():
    """A plain function of the family, the dtype and the device type: a
    qpsk or mpsk chain at f64 on a CUDA device raises, naming the chain,
    its family and the kernels not yet ported at f64."""
    for family, kernels in (("qpsk", "K5, K7"), ("mpsk", "K4, K6, K7")):
        with pytest.raises(ValueError, match=kernels) as err:
            tmodems.check_f64_kernels(family, F64, "cuda", "my chain")
        assert "my chain" in str(err.value) and family in str(err.value)
        tmodems.check_f64_kernels(family, F64, "cpu", "my chain")
        tmodems.check_f64_kernels(family, torch.float32, "cuda", "x")
    for family in ("afsk", "afsk_pll", "bpsk", "fsk"):
        tmodems.check_f64_kernels(family, F64, "cuda", "x")


def test_plans_with_unported_chains_raise_before_running():
    """run_plan and run_plan_banked refuse a plan with a qpsk chain at f64
    on the card before any chain runs (no resilient skip)."""
    qpsk = build_chain_spec(44100.0, _line("qpsk", "2400", "quadrature",
                                           "qpsk_2400", "0x1"))
    plan = RunPlan(chains=(qpsk,), reports=REPORTS)
    x = np.zeros(4410, np.int16)
    with pytest.raises(ValueError, match="K5, K7"):
        texecutor.run_plan(plan, x, 44100.0, device="cuda", dtype=F64)
    with pytest.raises(ValueError, match="K5, K7"):
        tbank.run_plan_banked(plan, x, 44100.0, device="cuda", dtype=F64)


def test_multi_recording_entry_points_raise_at_f64(monkeypatch):
    """run_banked_many, run_banked_files, run_plan_banked_many,
    run_plans_banked_pipelined and the stream raise at f64, by argument
    or by the mode, naming the entry point."""
    x = np.zeros(800, np.int16)
    plan = RunPlan(chains=tuple(PAIR), reports=REPORTS)
    calls = {
        "run_banked_many": lambda **kw: tbank.run_banked_many(
            PAIR, [x], device="cpu", **kw),
        "run_banked_files": lambda **kw: tbank.run_banked_files(
            PAIR, [x], device="cpu", **kw),
        "run_plan_banked_many": lambda **kw: tbank.run_plan_banked_many(
            plan, [x], BANK_RATE, device="cpu", **kw),
        "run_plans_banked_pipelined":
            lambda **kw: tbank.run_plans_banked_pipelined(
                [(plan, x, BANK_RATE)], device="cpu", **kw),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name}: the float64"):
            call(dtype=F64)
    with pytest.raises(ValueError, match="float64 parity mode"):
        StreamDecoder(PAIR, BANK_RATE, dtype=F64, device="cpu")
    monkeypatch.setenv(X64_VAR, "1")
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name}: the float64"):
            call()
    with pytest.raises(ValueError, match="float64 parity mode"):
        StreamDecoder(PAIR, BANK_RATE, device="cpu")
