"""The port's banked AFSK-300 IL2P+CRC slice against pymodem_tpu, end to end.

Same synthetic audio, same explicit block/overlap seconds on both sides (so
both plans are ``default_block_plan``'s), float32 on both sides, the same
codec route on both sides (host, and the device IL2P codec).  The port runs
on the CPU here, through its kernels' plain twins; packets (payload, CRC,
stream address) and report text must be identical.
"""

import os
import subprocess
import sys
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pymodem_tpu.config import (
    AX25CodecSpec,
    IL2PCodecSpec,
    ReportSpec,
    RunPlan,
    build_chain_spec,
)
from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu.synth import modulate as mod
from pymodem_tpu_torch.convert import bank_params_from_jax
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.synth import fixtures as tfx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 8000
GEOM = dict(block_seconds=2.0, overlap_seconds=2.5)


def _line(name, modem, invert="no", codec="il2p"):
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": modem, "config": "300", "options": {}},
        "slicer": {"type": "binary", "config": "300", "options": {}},
        "stream": {"type": "lfsr",
                   "options": {"poly": "0x3", "invert": invert}},
        "codec": {"type": codec, "options": {"crc": "yes"}},
    }


def _chain(*args, **kw):
    return build_chain_spec(float(RATE), _line(*args, **kw))


BASE = _chain("AFSK 300 Il2Pc Correlator", "afsk")
# 4-chain space-gain sweep (bench.py's pattern); on clean synthetic audio
# only the unity-gain chain decodes
SWEEP = [replace(BASE, name=f"s{i}",
                 modem=replace(BASE.modem, space_gain=0.7 + 0.1 * i))
         for i in range(4)]
# the afsk_300_pll-style pair: one chain per descrambler invert
PAIR = [_chain("AFSK 300 Il2Pc PLL", "afsk_pll", "no"),
        _chain("AFSK 300 Il2Pc PLL inverted", "afsk_pll", "yes")]
CARRIER = [replace(PAIR[0], name=f"pll{i}",
                   modem=replace(PAIR[0].modem, carrier_freq=1696.0 + i))
           for i in range(3)]
BANKS = {"sweep": SWEEP, "pll_pair": PAIR, "carrier_sweep": CARRIER}


def _audio():
    """~9 s of int16 AFSK-300 (1695/1705 Hz) carrying 3 IL2P+CRC frames."""
    rng = np.random.default_rng(20261016)
    sent, x = tfx.synthesize_for_chain(BASE, float(RATE), rng, n_frames=3,
                                       size=10, gap_bits=400)
    return sent, mod.to_int16(x)


def _audio_1600_1800():
    """The same frames at 1600/1800 Hz (as chip_smoke.py synthesises), which
    the "300" preset's correlators decode from any block phase."""
    rng = np.random.default_rng(20261016)
    sent = tfx.payloads(rng, count=3, size=10)
    line = tfx.il2p_line_bits(sent, polynomial=0x3, gap_bits=400)
    return sent, mod.to_int16(mod.afsk_modulate(line, float(RATE), 300.0,
                                                1600.0, 1800.0))


AUDIOS = {"audio": _audio, "audio_1600_1800": _audio_1600_1800}


@pytest.fixture(scope="module")
def audio():
    return _audio()


@pytest.fixture(scope="module")
def audio_1600_1800():
    return _audio_1600_1800()


def _packets(by_name):
    return {
        name: [(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
                int(p.streamaddress), int(p.bytes_corrected)) for p in pkts]
        for name, pkts in by_name.items()
    }


def _packet_diff(got, want) -> str:
    """The chains whose packets differ, as (address, CRC, corrected) of
    each side (port, then JAX)."""
    return "; ".join(
        f"{name}: port {[p[1:] for p in got.get(name, [])]} JAX "
        f"{[p[1:] for p in want.get(name, [])]}"
        for name in sorted(set(got) | set(want))
        if got.get(name) != want.get(name))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", sorted(BANKS))
def test_group_chains_matches_convert(name):
    chains = BANKS[name]
    jbanks = jbank.group_chains(chains, jnp.float32)
    tbanks = tbank.group_chains(chains, "cpu")
    assert len(jbanks) == len(tbanks) == 1
    jb, tb = jbanks[0], tbanks[0]
    assert (tb.kind, tb.trim, tb.up, tb.trim_post) == \
        (jb.kind, jb.trim, jb.up, jb.trim_post)
    assert (tb.stream_polys, tb.stream_inverts) == \
        (jb.stream_polys, jb.stream_inverts)
    want = _flat(bank_params_from_jax(jb.params, device="cpu"))
    got = _flat(tb.params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert ("space_scale" in tb.params) == (name == "sweep")
    assert ("pre_shared" in tb.params) == (name != "sweep")
    assert got["sps/"].dtype == torch.float32
    if name != "sweep":  # a given NCO sine table (XLA's sin) is carried over
        angle = np.arange(256, dtype=np.float32) * np.float32(2 * np.pi / 256)
        xla = np.array(jnp.sin(jnp.asarray(angle)))
        params = bank_params_from_jax(jb.params, sine_table=xla, device="cpu")
        assert torch.equal(params["sine_table"], torch.from_numpy(xla))


E2E_CASES = pytest.mark.parametrize(
    "name,audio_name", [("sweep", "audio"), ("pll_pair", "audio"),
                        ("sweep", "audio_1600_1800")],
    ids=["sweep", "pll_pair", "sweep_1600_1800"])
# Both packages' run_banked on one case, both codec routes, in a process of
# its own that sets JAX up as the tests' conftest.py does (the CPU, x64 on)
# but compiles its programs afresh, without the persistent compile cache:
# the result cannot depend on what earlier test files left in a shared
# test worker, nor on a cached executable compiled elsewhere.  Writes a
# pickle of {(package, codec): (packets, decoded payloads)} to the given
# file.
_E2E_SCRIPT = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
import jax.numpy as jnp
sys.path.insert(0, sys.argv[1])
import test_torch_bank as t
name, audio_name, out = sys.argv[2:5]
_, x = t.AUDIOS[audio_name]()
runs = {}
for codec in ("host", "device"):
    for package, by_name in (
            ("jax", t.jbank.run_banked(t.BANKS[name], x, dtype=jnp.float32,
                                       codec=codec, **t.GEOM)),
            ("port", t.tbank.run_banked(t.BANKS[name], x, codec=codec,
                                        device="cpu", **t.GEOM))):
        runs[package, codec] = (t._packets(by_name), sorted(
            bytes(p.data[16:-2]) for pkts in by_name.values() for p in pkts))
with open(out, "wb") as fh:
    pickle.dump(runs, fh)
"""
_E2E_RUNS: dict = {}


def _e2e_runs(name, audio_name, tmp_path_factory):
    """Both packages' packets on both routes for one case, computed once
    per (bank, audio) in this module, in a fresh process (_E2E_SCRIPT)."""
    import pickle

    key = (name, audio_name)
    if key not in _E2E_RUNS:
        out = tmp_path_factory.mktemp("e2e") / "runs.pkl"
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-c", _E2E_SCRIPT,
             os.path.join(REPO, "tests"), name, audio_name, str(out)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out, "rb") as fh:
            _E2E_RUNS[key] = pickle.load(fh)
    return _E2E_RUNS[key]


@E2E_CASES
def test_run_banked_matches_jax(name, audio_name, tmp_path_factory):
    """Packets equal the JAX package's; the space-gain sweep also on
    1600/1800 Hz tones."""
    sent, _ = AUDIOS[audio_name]()
    runs = _e2e_runs(name, audio_name, tmp_path_factory)
    (got_p, decoded), (want_p, _) = runs["port", "host"], runs["jax", "host"]
    assert got_p == want_p, _packet_diff(got_p, want_p)
    assert decoded == sorted(sent)


@E2E_CASES
def test_device_codec_matches_jax_and_host(name, audio_name,
                                           tmp_path_factory):
    """The device IL2P codec route (the default): packets equal the JAX
    package's device route and the port's host route on the same audio."""
    sent, _ = AUDIOS[audio_name]()
    runs = _e2e_runs(name, audio_name, tmp_path_factory)
    got_p, decoded = runs["port", "device"]
    want_p, host_p = runs["jax", "device"][0], runs["port", "host"][0]
    assert got_p == want_p, _packet_diff(got_p, want_p)
    assert got_p == host_p, _packet_diff(got_p, host_p)
    assert decoded == sorted(sent)


def test_run_plan_banked_report_matches_jax(audio):
    sent, x = audio
    plan = RunPlan(chains=tuple(SWEEP + PAIR),
                   reports=(ReportSpec("decoded", style="decoded_headers"),
                            ReportSpec("raw", style="raw")))
    want = jbank.run_plan_banked(plan, x, RATE, dtype=jnp.float32,
                                 codec="host", **GEOM)
    got = tbank.run_plan_banked(plan, x, RATE, codec="host", device="cpu",
                                **GEOM)
    assert got.reports == want.reports
    assert f"Unique, valid packets:  {len(sent)}\n" in got.reports[0]
    assert got.aggregate.count_bad() == 0


def test_run_plan_banked_device_report_matches_jax(audio):
    """The report on both packages' default route, the device codec."""
    sent, x = audio
    plan = RunPlan(chains=tuple(SWEEP + PAIR),
                   reports=(ReportSpec("decoded", style="decoded_headers"),))
    want = jbank.run_plan_banked(plan, x, RATE, dtype=jnp.float32, **GEOM)
    got = tbank.run_plan_banked(plan, x, RATE, device="cpu", **GEOM)
    assert got.reports == want.reports
    assert f"Unique, valid packets:  {len(sent)}\n" in got.reports[0]


def test_sync_tolerance_counts_il2p_chains_only():
    """A bank's IL2P sync tolerance is the largest of its IL2P chains'; an
    AX.25 chain has none and is left out: the JAX package's rule
    (``_submit_banked``), on stand-in banks of both kinds of chain."""
    il2p2 = replace(PAIR[0], codec=replace(PAIR[0].codec, sync_tolerance=2))
    ax25 = replace(PAIR[1], codec=AX25CodecSpec(ident="ax25"))
    cases = ([il2p2, ax25], [ax25, il2p2], [ax25], [PAIR[0], ax25],
             [il2p2, PAIR[0]])
    got = [tbank.sync_tolerance(SimpleNamespace(specs=specs))
           for specs in cases]
    want = [max((getattr(c.codec, "sync_tolerance", 0) for c in specs
                 if isinstance(c.codec, IL2PCodecSpec)), default=0)
            for specs in cases]
    assert got == want == [2, 2, 0, 0, 2]


FSK_RATE = 96000  # the FSK-9600 preset's own rate (tests/test_torch_fsk.py)


def _formerly_unported(kind):
    """(chain, rate, sent payloads, int16 audio) for the two AX.25 chains
    the port once refused: FSK-9600 AX.25 at 96 kHz and AFSK-300 AX.25 at
    8 kHz (on 1600/1800 Hz tones, which the "300" preset decodes from any
    block phase), each on 3 AX.25 frames of its own."""
    rng = np.random.default_rng(20261020)
    if kind == "fsk_ax25":
        chain = build_chain_spec(float(FSK_RATE), {
            **_line("fsk", "afsk", codec="ax25"),
            "modem": {"type": "fsk", "config": "9600", "options": {}},
            "slicer": {"type": "binary", "config": "9600", "options": {}}})
        sent, x = tfx.synthesize_for_chain(chain, float(FSK_RATE), rng,
                                           n_frames=3, size=10)
        return chain, FSK_RATE, sent, mod.to_int16(x)
    chain = _chain("ax", "afsk", codec="ax25")
    sent = tfx.payloads(rng, count=3, size=10)
    line = tfx.ax25_line_bits(sent, polynomial=0x3, invert=False,
                              gap_bits=400)
    return chain, RATE, sent, mod.to_int16(
        mod.afsk_modulate(line, float(RATE), 300.0, 1600.0, 1800.0))


@pytest.mark.parametrize("kind", ["fsk_ax25", "afsk_ax25"])
def test_unported_chains_raise(kind):
    """The two AX.25 chains this test once saw refused (the AX.25 codec was
    not ported) now run on both codec routes and give the JAX package's
    packets on the same audio, every frame decoded."""
    chain, rate, sent, x = _formerly_unported(kind)
    for codec in ("device", "host"):
        want = jbank.run_banked([chain], x, dtype=jnp.float32, codec=codec,
                                **GEOM)
        got = tbank.run_banked([chain], x, codec=codec, device="cpu", **GEOM)
        got_p, want_p = _packets(got), _packets(want)
        assert got_p == want_p, _packet_diff(got_p, want_p)
        decoded = {bytes(p.data[16:-2]) for p in got[chain.name]}
        assert set(sent) <= decoded, (kind, codec)


def _cli(module, *args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def _report(stdout: str) -> str:
    return stdout[stdout.index("Generating"):stdout.index("Elapsed time")]


def test_cli_matches_jax(tmp_path, audio):
    import json

    from scipy.io import wavfile

    sent, x = audio
    wav = tmp_path / "afsk300.wav"
    wavfile.write(str(wav), RATE, x)
    cfg = tmp_path / "afsk300.json"
    cfg.write_text(json.dumps(_line(BASE.name, "afsk")) + "\n" + json.dumps({
        "object_name": "report", "object_type": "report",
        "options": {"style": "decoded_headers", "destination": "std_out"},
    }) + "\n")
    port = _cli("pymodem_tpu_torch", str(cfg), str(wav),
                env_extra={"PYMODEM_TPU_TORCH_DEVICE": "cpu"})
    assert port.returncode == 0, port.stderr[-2000:]
    ref = _cli("pymodem_tpu", str(cfg), str(wav),
               env_extra={"PYMODEM_TPU_PLATFORM": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]
    line = f"Unique, valid packets:  {len(sent)}\n"
    assert line in port.stdout and line in ref.stdout
    assert _report(port.stdout) == _report(ref.stdout)


def test_cli_exit_codes(tmp_path, monkeypatch):
    from scipy.io import wavfile

    from pymodem_tpu_torch.cli import main

    monkeypatch.setenv("PYMODEM_TPU_TORCH_DEVICE", "cpu")
    assert main(["prog"]) == 2
    wav = tmp_path / "x.wav"
    cfg = tmp_path / "c.json"
    cfg.write_text("{}")
    assert main(["prog", str(cfg), str(wav)]) == 4
    wavfile.write(str(wav), RATE, np.zeros(RATE, dtype=np.int16))
    assert main(["prog", str(tmp_path / "none.json"), str(wav)]) == 3
