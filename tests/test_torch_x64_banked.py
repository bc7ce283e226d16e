"""The port's float64 parity mode on the CPU, against pymodem_tpu at x64:
the banked runtime, the CLI and the multi-recording entry points (the
executor, the FIRs, loops and slicers and the kernels' routes at f64:
test_torch_x64.py).

* the banked runtime: the f64 bank's leaves equal the JAX package's
  (an AFSK space-gain sweep, the PLL pair, pre-shared ``qpsk`` and
  ``mpsk`` sweeps); ``run_plan_banked(dtype=float64)`` on a 3-chain AFSK
  space-gain sweep (demodulated per chain at f64, no ``space_scale`` row)
  with the PLL pair (``pre_shared``), on a Costas ``qpsk`` pair and on an
  ``mpsk`` pair: packets and report text equal;
* the CLI under ``PYMODEM_TPU_TORCH_X64=1`` and ``PYMODEM_TPU_X64=1``,
  one-at-a-time and (with the banked runtime) its batch route;
* the multi-recording entry points and the stream run at f64 by argument
  and by the mode (their results against JAX's: tests/test_torch_many.py,
  tests/test_torch_streaming.py).
"""

import json
import os
import re
import subprocess
import sys
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_x64_cases import (
    F64,
    FAMILIES,
    REPO,
    REPORTS,
    _audio,
    _line,
    _packets,
)
from pymodem_tpu.config import RunPlan as JRunPlan
from pymodem_tpu.config import build_chain_spec as jbuild_chain_spec
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu_torch import cli as tcli
from pymodem_tpu_torch.config import ReportSpec, RunPlan, build_chain_spec
from pymodem_tpu_torch.convert import bank_params_from_jax
from pymodem_tpu_torch.device import resolve_dtype
from pymodem_tpu_torch.dsp import window_design as wd
from pymodem_tpu_torch.mode import X64_VAR
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.runtime.stream import StreamDecoder
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod


# ---------------------------------------------------------------------------
# the banked runtime at f64
# ---------------------------------------------------------------------------

BANK_RATE = 8000.0
GEOM = dict(block_seconds=2.0, overlap_seconds=2.5)
PSK_GEOM = dict(block_seconds=1.5, overlap_seconds=1.5)


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


def _carrier_sweep(build, modem, preset, carrier):
    """A 2-chain carrier sweep of a PSK preset at 8 kHz, 0.25 Hz apart
    (pre-shared: one band-pass for both chains)."""
    base = build(BANK_RATE, _line(modem, preset, "quadrature", "qpsk_2400",
                                  "0x1", name=f"{modem} {preset}"))
    return [replace(base, name=f"{modem}{i}",
                    modem=replace(base.modem,
                                  carrier_freq=carrier + 0.25 * i),
                    codec=replace(base.codec, ident=f"{modem}{i}"))
            for i in range(2)]


def _mpsk_pair(build):
    """The smoke run's ``mpsk_bpsk1200_pair`` cut to 16 kHz: two MPSK
    BPSK-1200 chains that the AGC attack (500, 400) keeps apart."""
    base = build(MPSK_PAIR_RATE, _line("mpsk", "bpsk_1200", "quadrature",
                                       "bpsk_1200", name="mb500"))
    return [base, replace(base, name="mb400", modem=replace(
        base.modem, agc=replace(base.modem.agc, attack_rate=400.0)),
        codec=replace(base.codec, ident="mb400"))]


MPSK_PAIR_RATE = 16000.0
SWEEP, PAIR = _sweep(build_chain_spec), _pair(build_chain_spec)
# the PSK banks: their builders, given build_chain_spec, and rates
PSK_BANKS = {
    "qpsk_sweep": (lambda b: _carrier_sweep(b, "qpsk", "2400", 1800.0),
                   BANK_RATE),
    "mpsk_sweep": (lambda b: _carrier_sweep(b, "mpsk", "qpsk_2400", 1500.0),
                   BANK_RATE),
    "mpsk_pair": (_mpsk_pair, MPSK_PAIR_RATE),
}


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


@pytest.mark.parametrize("which", ["sweep", "pll_pair", "qpsk_sweep",
                                   "mpsk_sweep"])
def test_group_chains_f64_matches_jax(which):
    """The f64 bank's leaves equal the JAX package's f64 bank leaf for
    leaf: float64, no space_scale row on the sweep, pre_shared on the
    carrier pair and the PSK sweeps (the mpsk sweep's detector table the
    reference's); the NCO tables are the reference wavetable and its
    quarter-turn shift."""
    make = {"sweep": _sweep, "pll_pair": _pair}.get(which) or \
        PSK_BANKS[which][0]
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
    assert ("pre_shared" in tb.params) == (which != "sweep")
    if which == "mpsk_sweep":
        spec = chains[0].modem
        table = wd.qpsk_error_table(int(spec.pd_granularity), spec.pd_gain)
        assert np.array_equal(tb.params["pd_error_table"][0].numpy(),
                              table.astype(np.int32).reshape(-1))
    if which != "sweep":
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


_PSK_AUDIO: dict = {}


def _psk_bank_audio(which):
    """(payloads, int16 audio) of a PSK bank: 2 frames of 10 bytes, 300
    idle bits apart, line-coded per its first chain."""
    if which not in _PSK_AUDIO:
        make, rate = PSK_BANKS[which]
        sent, x = tfx.synthesize_for_chain(
            make(build_chain_spec)[0], rate, np.random.default_rng(20261118),
            n_frames=2, size=10, gap_bits=300)
        _PSK_AUDIO[which] = (sent, tmod.to_int16(x))
    return _PSK_AUDIO[which]


@pytest.mark.parametrize("which", ["qpsk_sweep", "mpsk_pair"])
def test_run_plan_banked_psk_f64_matches_jax(which):
    """run_plan_banked at f64 on a pre-shared Costas ``qpsk`` pair (K14's
    twin on shared rows, K16's) and on an ``mpsk`` pair the AGC keeps
    apart (K13's twin over C*B lanes, per-chain Hilbert FIRs, K15's on the
    reference's detector table): packets and report text equal to the JAX
    package's at x64, every chain decoding every frame."""
    make, rate = PSK_BANKS[which]
    sent, x = _psk_bank_audio(which)
    reports = (ReportSpec("decoded", style="decoded_headers"),)
    chains = tuple(make(build_chain_spec))
    want = jbank.run_plan_banked(
        JRunPlan(chains=tuple(make(jbuild_chain_spec)), reports=reports), x,
        rate, dtype=jnp.float64, resilient=False, **PSK_GEOM)
    got = tbank.run_plan_banked(RunPlan(chains=chains, reports=reports), x,
                                rate, resilient=False, device="cpu",
                                dtype=F64, **PSK_GEOM)
    assert _packets(got.aggregate.chains) == _packets(want.aggregate.chains)
    assert got.reports == want.reports
    assert f"Unique, valid packets:  {len(sent)}\n" in got.reports[0]
    assert got.aggregate.count_bad() == 0
    for chain in got.aggregate.chains:
        assert sorted(bytes(p.data[16:-2]) for p in chain) == sorted(sent)


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


_JAX_BATCH = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from pymodem_tpu.cli import run_decode_batch
print(json.dumps(run_decode_batch(json.loads(sys.argv[1]))))
"""


def _strip(text: str) -> str:
    return re.sub(r"Elapsed time.*\n?", "", text)


def test_cli_batch_x64_banked_pipelines_as_jax(tmp_path, monkeypatch):
    """``run_decode_batch`` under ``PYMODEM_TPU_TORCH_X64=1`` with
    ``PYMODEM_TPU_TORCH_RUNTIME=banked`` pipelines the batch through
    ``run_plans_banked_pipelined`` at f64 (one call, no one-at-a-time
    fallback), and its outputs equal the JAX package's batch route under
    ``PYMODEM_TPU_X64=1 PYMODEM_TPU_RUNTIME=banked``: two configs, every
    frame decoded."""
    from scipy.io import wavfile

    requests, sent = [], []
    for family in ("afsk300", "fsk9600"):
        line, rate = FAMILIES[family]
        frames, x = _audio(family)
        wav, cfg = tmp_path / f"{family}.wav", tmp_path / f"{family}.json"
        wavfile.write(str(wav), int(rate), x)
        cfg.write_text("".join(json.dumps(d) + "\n" for d in (
            line, {"object_name": "report", "object_type": "report",
                   "options": {"style": "decoded_headers",
                               "destination": "std_out"}})))
        requests.append((str(cfg), str(wav)))
        sent.append(frames)
    monkeypatch.setenv(X64_VAR, "1")
    monkeypatch.setenv("PYMODEM_TPU_TORCH_RUNTIME", "banked")
    monkeypatch.setenv("PYMODEM_TPU_TORCH_DEVICE", "cpu")
    calls = []
    pipelined = tbank.run_plans_banked_pipelined

    def spy(jobs, **kw):
        calls.append((len(jobs), resolve_dtype(kw.get("dtype"))))
        return pipelined(jobs, **kw)

    monkeypatch.setattr(tbank, "run_plans_banked_pipelined", spy)
    got = tcli.run_decode_batch(requests)
    assert calls == [(2, F64)]
    env = dict(os.environ, PYTHONPATH=REPO, PYMODEM_TPU_X64="1",
               PYMODEM_TPU_RUNTIME="banked")
    proc = subprocess.run([sys.executable, "-c", _JAX_BATCH,
                           json.dumps(requests)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [(c, _strip(o)) for c, o in got] == \
        [(c, _strip(o)) for c, o in want]
    for (code, out), frames in zip(got, sent):
        assert code == 0 and "banked runtime failed" not in out
        assert f"Unique, valid packets:  {len(frames)}\n" in out



class _Grouped(Exception):
    """Raised by the spied ``group_chains`` once it has seen the dtype."""


def test_multi_recording_entry_points_take_f64(monkeypatch):
    """run_banked_many, run_banked_files, run_plan_banked_many,
    run_plans_banked_pipelined and the stream build float64 banks at f64,
    by argument and by the mode (None), and float32 banks otherwise.  The
    spied ``group_chains`` stops each call there (their decodes against
    the JAX package's: tests/test_torch_many.py,
    tests/test_torch_streaming.py)."""
    x = np.zeros(800, np.int16)
    plan = RunPlan(chains=tuple(PAIR), reports=REPORTS)
    calls = {
        "run_banked_many": lambda **kw: tbank.run_banked_many(
            PAIR, [x], device="cpu", **kw),
        "run_banked_files": lambda **kw: tbank.run_banked_files(
            PAIR, [x], device="cpu", **kw),
        "run_plan_banked_many": lambda **kw: tbank.run_plan_banked_many(
            plan, [x], BANK_RATE, device="cpu", resilient=False, **kw),
        "run_plans_banked_pipelined":
            lambda **kw: tbank.run_plans_banked_pipelined(
                [(plan, x, BANK_RATE)], device="cpu", **kw),
        "StreamDecoder": lambda **kw: StreamDecoder(
            PAIR, BANK_RATE, device="cpu", **kw),
    }
    seen = []

    def spy(chains, device="cuda", dtype=torch.float32):
        seen.append(resolve_dtype(dtype))
        raise _Grouped

    monkeypatch.setattr(tbank, "group_chains", spy)
    for how, kw, want in (("argument", dict(dtype=F64), F64),
                          ("mode", {}, F64),
                          ("float32", dict(dtype=torch.float32),
                           torch.float32)):
        if how == "mode":
            monkeypatch.setenv(X64_VAR, "1")
        for name, call in calls.items():
            seen.clear()
            with pytest.raises(_Grouped):
                call(**kw)
            assert seen == [want], (name, how)
