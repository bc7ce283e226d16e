"""The port's AX.25 codec against pymodem_tpu, on the CPU.

* ``codecs/ax25_device.ax25_decode_blocks`` (here through the plain twin
  of kernel K9, ``ax25_deframe``) against the JAX package's on every
  output, on the cases of tests/test_ax25_device.py: frames, a noise
  prefix, stuffing and aborts, overflow setting ``dropped``, a narrowed
  packet buffer and a frame over the 1023-byte cap; integer outputs
  bitwise.
* ``run_banked`` on a small AFSK-1200 AX.25 space-gain sweep and on a
  mixed AFSK-300 AX.25/IL2P bank (two codec sub-groups), on both codec
  routes: packets equal to the JAX package's same route; the device
  route's escalation and host fallback on dense AX.25 traffic.
* ``run_plan_banked`` reports and the CLI against the JAX package's.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pymodem_tpu.codecs.ax25_device import ax25_decode_blocks as jax_decode
from pymodem_tpu.config import ReportSpec, RunPlan, build_chain_spec
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu.synth.encode import (
    ax25_ui_frame,
    bits_to_bytes_msb,
    hdlc_encode,
)
from pymodem_tpu_torch import profiling
from pymodem_tpu_torch.codecs.ax25_device import (
    ax25_decode_blocks,
    ax25_deframe,
    ax25_deframe_rows,
)
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 8000
GEOM = dict(block_seconds=2.0, overlap_seconds=1.5)
GEOM_300 = dict(block_seconds=2.0, overlap_seconds=2.5)


# ---------------------------------------------------------------------------
# ax25_decode_blocks against the JAX package's
# ---------------------------------------------------------------------------


def _frames_bits(rng):
    bits = []
    for i in range(4):
        bits += [int(b) for b in rng.integers(0, 2, 200)]
        payload = bytes(rng.choice(
            np.frombuffer(b"ABCdef123 ", dtype=np.uint8), 20 + i * 10))
        bits += hdlc_encode(ax25_ui_frame("KI5ABC", "N0CALL", payload),
                            flag_count=3)
    return bits


def _stress_bits(rng):
    bits = []
    for _ in range(30):
        bits += [1] * int(rng.integers(1, 12))
        bits += [0] * int(rng.integers(1, 3))
    bits += hdlc_encode(ax25_ui_frame("AB1CDE", "FG2HIJ",
                                      b"Stress! 0123456789"), flag_count=2)
    return bits + [1] * 20 + [0]


def _overflow_bits(rng):
    bits = []
    for _ in range(6):
        bits += hdlc_encode(ax25_ui_frame("KI5ABC", "N0CALL",
                                          b"0123456789ABCDEFGH"),
                            flag_count=2)
    return bits


def _long_frame_bits(rng):
    """A 1100-byte frame (over the 1023-byte cap: the counter reset) and a
    short one after it."""
    payload = bytes(rng.integers(32, 127, 1100).astype(np.uint8))
    bits = hdlc_encode(ax25_ui_frame("KI5ABC", "N0CALL", payload))
    return bits + hdlc_encode(ax25_ui_frame("KI5ABC", "N0CALL", b"tail" * 6))


def _noise_stream(rng):
    return rng.integers(0, 256, 3000).astype(np.uint8)


def _to_stream(bits):
    bits = bits + [0] * ((8 - len(bits) % 8) % 8)
    return np.array(bits_to_bytes_msb(bits), np.uint8)


# (stream maker, max_packets, max_packet_len, max_packet_length)
CASES = {
    "frames": (lambda r: _to_stream(_frames_bits(r)), 8, None, 1023),
    "noise_prefix": (lambda r: np.concatenate(
        [_noise_stream(r), _to_stream(_frames_bits(r))]), 16, None, 1023),
    "stuffing_and_aborts": (lambda r: _to_stream(_stress_bits(r)), 8, None,
                            1023),
    "overflow_dropped": (lambda r: _to_stream(_overflow_bits(r)), 4, None,
                         1023),
    "narrowed_buffer": (lambda r: _to_stream(_frames_bits(r)), 8, 40, 1023),
    "long_frame": (lambda r: _to_stream(_long_frame_bits(r)), 8, None,
                   1023),
    "short_cap": (lambda r: _to_stream(_frames_bits(r)), 8, None, 30),
}


def _blocks(stream, rng):
    """(2, 2, K) rows: the stream, its first half, noise, and the stream
    with a count past K (the compaction's full count when slots drop)."""
    K = -(-len(stream) // 128) * 128
    data = np.zeros((2, 2, K), np.uint8)
    data[0, 0, : len(stream)] = stream
    data[0, 1, : len(stream) // 2] = stream[: len(stream) // 2]
    data[1, 0] = rng.integers(0, 256, K)
    data[1, 1, : len(stream)] = stream
    counts = np.array([[len(stream), len(stream) // 2], [K, K + 40]],
                      np.int32)
    addr = (np.arange(4 * K, dtype=np.int32).reshape(2, 2, K) + 1)
    return data, counts, addr


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_blocks_matches_jax(case):
    """Every output equals the JAX package's, value for value."""
    make, max_packets, max_len, cap = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 9)
    data, counts, addr = _blocks(make(rng), rng)
    want = jax_decode(jnp.asarray(data), jnp.asarray(counts),
                      jnp.asarray(addr), max_packets=max_packets,
                      max_packet_len=max_len, max_packet_length=cap)
    got = ax25_decode_blocks(torch.from_numpy(data),
                             torch.from_numpy(counts),
                             torch.from_numpy(addr), max_packets=max_packets,
                             max_packet_len=max_len, max_packet_length=cap)
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                      err_msg=key)
    if case == "overflow_dropped":
        assert int(got["dropped"][0, 0]) == 2
    if case in ("frames", "noise_prefix"):
        assert int(got["crc_ok"][0, 0].sum()) == 4


def test_wrapper_takes_the_twin_on_the_cpu():
    """On CPU tensors the K9 wrapper runs the plain twin (no launch
    counted); its outputs are the twin's."""
    rng = np.random.default_rng(3)
    data, counts, _ = _blocks(_to_stream(_frames_bits(rng)), rng)
    d = torch.from_numpy(data.reshape(4, -1))
    c = torch.from_numpy(counts.reshape(4))
    before = ax25_deframe_rows.launches
    got = ax25_deframe_rows(d, c, 8, 18, 1023)
    want = ax25_deframe(d, c, 8, 18, 1023)
    assert ax25_deframe_rows.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="bad shapes"):
        ax25_deframe_rows(d, c[:2], 8, 18, 1023)


# ---------------------------------------------------------------------------
# banks end to end
# ---------------------------------------------------------------------------


def _line(name, modem, preset, invert, codec):
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": modem, "config": preset, "options": {}},
        "slicer": {"type": "binary", "config": preset, "options": {}},
        "stream": {"type": "lfsr",
                   "options": {"poly": "0x3", "invert": invert}},
        "codec": {"type": codec, "options": {"crc": "yes"}},
    }


def _spec(name, modem, preset, invert, codec):
    return build_chain_spec(float(RATE), _line(name, modem, preset, invert,
                                               codec))


def _variant(spec, name, **modem):
    return replace(spec, name=name, modem=replace(spec.modem, **modem),
                   codec=replace(spec.codec, ident=name))


AX1200 = _spec("AFSK 1200 AX25", "afsk", "1200", "yes", "ax25")
# a 3-chain space-gain sweep around unity: every chain decodes every frame
SWEEP = [_variant(AX1200, f"a{i}", space_gain=0.9 + 0.1 * i)
         for i in range(3)]
IL2P300 = _spec("AFSK 300 Il2Pc", "afsk", "300", "no", "il2p")
AX300 = _spec("AFSK 300 AX25", "afsk", "300", "yes", "ax25")
# the reference's afsk_300.json pattern: IL2P+CRC correlator chains and an
# AX.25 chain in one bank, two codec sub-groups
MIXED = [_variant(IL2P300, "il2p_a"), _variant(AX300, "ax25"),
         _variant(IL2P300, "il2p_b")]
BANKS = {"ax25_sweep": (SWEEP, GEOM), "mixed": (MIXED, GEOM_300)}


@pytest.fixture(scope="module")
def ax25_audio():
    """~8.6 s of 8 kHz int16 AFSK-1200 (1200/2200 Hz) carrying 4 AX.25
    frames of 60-byte payloads, NRZI-coded as ax25_line_bits codes them."""
    rng = np.random.default_rng(20261017)
    sent, x = tfx.synthesize_for_chain(AX1200, float(RATE), rng, n_frames=4,
                                       size=60, gap_bits=1500)
    return {name: sent for name in ("a0", "a1", "a2")}, tmod.to_int16(x)


@pytest.fixture(scope="module")
def mixed_audio():
    """~19 s of 8 kHz int16 AFSK-300 at 1600/1800 Hz (tones the "300"
    preset decodes from any block phase): 2 IL2P+CRC frames, then 2 AX.25
    frames, each part with its own free-running scrambler."""
    rng = np.random.default_rng(20261018)
    il2p = tfx.payloads(rng, count=2, size=12)
    ax25 = tfx.payloads(rng, count=2, size=12)
    line = (tfx.il2p_line_bits(il2p, polynomial=0x3, invert=False,
                               gap_bits=300)
            + tfx.ax25_line_bits(ax25, polynomial=0x3, invert=True,
                                 gap_bits=300))
    x = tmod.afsk_modulate(line, float(RATE), 300.0, 1600.0, 1800.0)
    sent = {"il2p_a": il2p, "il2p_b": il2p, "ax25": ax25}
    return sent, tmod.to_int16(x)


AUDIO_OF = {"ax25_sweep": "ax25_audio", "mixed": "mixed_audio"}


def _packets(by_name):
    return {name: [(int(p.streamaddress), list(map(int, p.data)),
                    int(p.bytes_corrected)) for p in pkts]
            for name, pkts in by_name.items()}


def _payloads(by_name):
    return {name: sorted(bytes(p.data[16:-2]) for p in pkts)
            for name, pkts in by_name.items()}


_PORT_RUNS: dict = {}


def _port_run(name, x, codec):
    """The port's run_banked on the CPU, once per (bank, codec) here."""
    if (name, codec) not in _PORT_RUNS:
        chains, geom = BANKS[name]
        tbank._CODEC_BUDGET_CACHE.clear()
        _PORT_RUNS[name, codec] = tbank.run_banked(chains, x, codec=codec,
                                                   device="cpu", **geom)
    return _PORT_RUNS[name, codec]


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("name", sorted(BANKS))
def test_run_banked_matches_jax(name, codec, request):
    """Packets (address, bytes, corrections) equal the JAX package's on the
    same route, and every chain decodes every frame of its codec."""
    sent, x = request.getfixturevalue(AUDIO_OF[name])
    chains, geom = BANKS[name]
    want = jbank.run_banked(chains, x, dtype=jnp.float32, codec=codec,
                            **geom)
    got = _port_run(name, x, codec)
    assert _packets(got) == _packets(want)
    assert _payloads(got) == {k: sorted(v) for k, v in sent.items()}


@pytest.mark.parametrize("name", sorted(BANKS))
def test_device_route_equals_host_route(name, request):
    """On the same audio the device codecs give the host FSMs' packets,
    and the mixed bank runs one device codec per codec sub-group."""
    _, x = request.getfixturevalue(AUDIO_OF[name])
    chains, _ = BANKS[name]
    bank = tbank.group_chains(chains, "cpu")
    assert len(bank) == 1
    groups = tbank._codec_subgroups(bank[0])
    kinds = [key[0] for key, _ in groups]
    assert kinds == (["il2p", "ax25"] if name == "mixed" else ["ax25"])
    assert _packets(_port_run(name, x, "device")) == \
        _packets(_port_run(name, x, "host"))


def test_ax25_blocks_without_il2p_candidates_decode(ax25_audio):
    """host_codec_collect skips candidate-free blocks of IL2P chains only:
    with an all-zero sync map an AX.25 bank still gives every packet."""
    _, x = ax25_audio
    bank = tbank.group_chains(SWEEP, "cpu")[0]
    plan = tbank.bank_plan(bank, len(x), **GEOM)
    audio = torch.from_numpy(x)
    data, addr, count, sync = tbank.dispatch_bank(bank, plan, audio, 0)
    empty = torch.zeros_like(sync)
    got = tbank.host_codec_collect(bank, plan, 0, (data, addr, count, empty))
    want = tbank.host_codec_collect(bank, plan, 0, (data, addr, count, sync))
    assert _packets(got) == _packets(want)
    assert all(len(v) == 4 for v in got.values())


def test_overlap_covers_the_longest_ax25_frame():
    """The auto overlap covers the AX.25 protocol maximum (1023 bytes at
    6/5 stuffing plus flags), as the JAX package's rule gives it."""
    for chains in (SWEEP, [AX300]):
        bank = tbank.group_chains(chains, "cpu")[0]
        got = tbank.bank_auto_geometry(bank, float(RATE))[1]
        want = max(jbank._protocol_max_packet_seconds(c) for c in chains)
        assert got > want
        assert max(tbank._protocol_max_packet_seconds(c) for c in chains) \
            == want


@pytest.fixture(scope="module")
def dense_ax25():
    """10 AX.25 frames 200 idle bits apart at 1200 Bd: 3-4 closing flags in
    each 3.5 s block window."""
    rng = np.random.default_rng(20261019)
    sent, x = tfx.synthesize_for_chain(AX1200, float(RATE), rng,
                                       n_frames=10, size=20, gap_bits=200)
    chain = SWEEP[1]
    roomy = tbank.run_banked([chain], x, codec="host", device="cpu", **GEOM)
    # the idle fill between frames closes some CRC-bad frames too
    assert set(sent) <= {bytes(p.data[16:-2]) for p in roomy[chain.name]}
    return chain, np.asarray(x, np.float32), _packets(roomy)


def _counted(fn):
    profiling.reset()
    profiling.enable(True)
    try:
        return fn(), profiling.counts()
    finally:
        profiling.enable(False)
        profiling.reset()


def test_escalation_recovers_every_ax25_packet(dense_ax25):
    """One packet slot a block saturates; the ladder doubles it on the
    device until no block is dropped: the host route's packets."""
    chain, x, want = dense_ax25
    tbank._CODEC_BUDGET_CACHE.clear()
    got, counts = _counted(lambda: tbank.run_banked(
        [chain], x, max_packets_per_block=1, device="cpu", **GEOM))
    assert counts.get("device_codec_escalate", 0) >= 1, counts
    assert counts.get("packet_fallback_blocks", 0) == 0, counts
    assert counts.get("candidate_budget", 0) == 0, counts
    assert _packets(got) == want


def test_host_fallback_recovers_every_ax25_packet(dense_ax25, monkeypatch):
    """With the ladder capped at one slot, saturated blocks decode on the
    host AX.25 state machine: the same packets."""
    chain, x, want = dense_ax25
    monkeypatch.setattr(tbank, "MP_CAP", 1)
    tbank._CODEC_BUDGET_CACHE.clear()
    got, counts = _counted(lambda: tbank.run_banked(
        [chain], x, max_packets_per_block=1, device="cpu", **GEOM))
    assert counts.get("device_codec_escalate", 0) == 0, counts
    assert counts.get("packet_fallback_blocks", 0) >= 1, counts
    assert _packets(got) == want


def test_run_plan_banked_reports_match_jax(mixed_audio):
    """The decoded_headers and raw reports of a plan holding both banks'
    chains, on both routes, equal the JAX package's."""
    plan = RunPlan(chains=tuple(MIXED),
                   reports=(ReportSpec("decoded", style="decoded_headers"),
                            ReportSpec("raw", style="raw")))
    sent, x = mixed_audio
    for codec in ("host", "device"):
        want = jbank.run_plan_banked(plan, x, RATE, dtype=jnp.float32,
                                     codec=codec, **GEOM_300)
        got = tbank.run_plan_banked(plan, x, RATE, codec=codec,
                                    device="cpu", **GEOM_300)
        assert got.reports == want.reports
        assert "Unique, valid packets:  4\n" in got.reports[0]
        assert got.aggregate.count_bad() == 0


def _cli(module, *args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def _report(stdout: str) -> str:
    return stdout[stdout.index("Generating"):stdout.index("Elapsed time")]


def test_cli_matches_jax(tmp_path, ax25_audio):
    """The CLI on an AX.25 config: exit 0, every frame, and the same report
    as the JAX package's CLI."""
    from scipy.io import wavfile

    sent, x = ax25_audio
    wav = tmp_path / "afsk1200.wav"
    wavfile.write(str(wav), RATE, x)
    cfg = tmp_path / "afsk1200.json"
    cfg.write_text(json.dumps(_line(AX1200.name, "afsk", "1200", "yes",
                                    "ax25")) + "\n" + json.dumps({
        "object_name": "report", "object_type": "report",
        "options": {"style": "decoded_headers", "destination": "std_out"},
    }) + "\n")
    port = _cli("pymodem_tpu_torch", str(cfg), str(wav),
                env_extra={"PYMODEM_TPU_TORCH_DEVICE": "cpu"})
    assert port.returncode == 0, port.stderr[-2000:]
    ref = _cli("pymodem_tpu", str(cfg), str(wav),
               env_extra={"PYMODEM_TPU_PLATFORM": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]
    line = f"Unique, valid packets:  {len(sent['a0'])}\n"
    assert line in port.stdout and line in ref.stdout
    assert _report(port.stdout) == _report(ref.stdout)
