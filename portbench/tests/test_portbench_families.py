"""A modem family is new files: transmitters found by their modulation, the
reference's block geometry by the port's rules at the chain's bits per
symbol, and the configurations already measured left as they were."""

import hashlib
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import loadgen
from portbench.reference import decode
from portbench.tests import tiny_bench
from portbench.tests.tiny_bench import SRC

SEED = 2**33 + 17


def _config(name: str) -> dict:
    return json.loads((SRC / f"configs/{name}.json").read_text())


def _mix(name: str, seconds: float) -> dict:
    m = json.loads((SRC / f"traffic/{name}.json").read_text())
    m["seconds"] = m["segment_seconds"] = seconds
    return m


# the recordings' sha256 and frames sent, 120 s of each mix, as the
# generator made them before transmitters were found by their modulation
@pytest.mark.parametrize("config,mix,sent,digest", [
    ("afsk300_pll_sweep64", "busy_10min", 43,
     "f81329dffc1693183b554a00bcde6671a0b9ef0bcecf7b7b158639e0874d6872"),
    ("afsk300_pll_sweep64", "quiet_hour", 2,
     "34528b8f935c0c528e0b4cede75ff4996b542ee3a870ecc5de91116150983b42"),
    ("afsk1200_ax25_sweep8", "busy_10min", 163,
     "74aabcd1ad9421d8f72e35df536764c61fb4a2a1580792f9a6742847a10dcbed"),
])
def test_recordings_of_the_measured_configurations_are_unchanged(
        config, mix, sent, digest):
    recs, n = loadgen.recordings(_config(config), _mix(mix, 120), SEED)
    h = hashlib.sha256()
    for r in recs:
        h.update(r.tobytes())
    assert (n, h.hexdigest()) == (sent, digest)


def _port_geometry(lines: list[dict], rate: float, n_audio: int) -> tuple:
    from pymodem_tpu_torch.config import build_chain_spec
    from pymodem_tpu_torch.runtime import bank

    chains = [build_chain_spec(float(rate), line) for line in lines
              if line.get("object_type") == "demod_chain"]
    (b,) = bank.group_chains(chains, device="cpu")
    plan = bank.bank_plan(b, n_audio)
    return (plan.trim, plan.block_len, plan.overlap,
            bank.blocks_per_group(b, plan), bank.bank_capacity(b, plan))


# families with no reference modem stage yet: what a stage file would say
# (the port's working set and coherence; the trim is the port's)
_STUBS = {"mpsk": (True, 48), "fsk": (False, 24)}


def _geometry_case(name: str):
    if name == "qpsk2400":
        return tiny_bench.qpsk2400_sweep()
    if name == "fsk4":
        return tiny_bench.fsk4_sweep()
    return _config(name)


@pytest.mark.parametrize("name,seconds,parent", [
    ("afsk300_pll_sweep64", 3600, (318, 750000, 250000, 6, 7048)),
    ("afsk300_pll_sweep64", 600, (318, 750000, 250000, 4, 7048)),
    ("afsk1200_ax25_sweep8", 600, (262, 1132576, 377525, 24, 7720)),
    ("qpsk2400", 600, None),
    ("qpsk2400", 3600, None),
    ("fsk4", 600, None),
])
def test_reference_geometry_equals_the_ports(name, seconds, parent,
                                             monkeypatch):
    """``decode.geometry`` against the port's ``bank_plan``,
    ``bank_capacity`` and ``blocks_per_group`` over one bank; where the
    benchmark already measured the configuration, also against what the
    reference gave before this rule covered every family."""
    cfg = _geometry_case(name)
    rate = float(cfg["sample_rate"])
    n_audio = int(seconds * rate)
    port = _port_geometry(cfg["lines"], rate, n_audio)
    chains = decode.chains_from_lines(cfg["lines"], rate)
    kind = chains[0].modem.kind
    if kind in _STUBS:
        coherent, per_sample = _STUBS[kind]
        monkeypatch.setitem(
            sys.modules, f"portbench.reference.modems.{kind}",
            SimpleNamespace(COHERENT=coherent,
                            BYTES_PER_CHAIN_SAMPLE=per_sample,
                            params=lambda spec: None,
                            trim=lambda p: port[0]))
    geo = decode.geometry(chains, n_audio, rate)
    mine = (geo.trim, geo.block_len, geo.overlap, geo.per_group,
            geo.capacity)
    assert mine == port
    if parent is not None:
        assert mine == parent


def test_qpsk_bank_geometry_takes_two_bits_a_symbol():
    """The 10 min QPSK sweep: 40 blocks of 15 s at 44.1 kHz, the overlap
    holding the longest IL2P packet at 2,400 bit/s, byte slots for two
    bits a decision."""
    cfg = tiny_bench.qpsk2400_sweep()
    port = _port_geometry(cfg["lines"], 44100.0, 600 * 44100)
    assert port == (488, 661500, 220500, 40, 9016)


def test_unknown_modulation_names_the_file_it_looked_for():
    cfg = tiny_bench.qpsk2400_sweep()
    cfg["transmitter"]["modulation"] = "ofdm"
    mix = {"recordings": 1, "seconds": 2, "snr_db": [30, 30],
           "snr_bandwidth_hz": 3000,
           "frames": {"il2p": {"arrivals": "back_to_back",
                               "payload_bytes": [20, 30], "cycle": 2}}}
    with pytest.raises(ValueError, match=r"transmitters/ofdm\.py"):
        loadgen.recordings(cfg, mix, SEED)


@pytest.mark.parametrize("modulation,tx", [
    ("afsk", {"bit_rate": 1200.0, "mark_freq": 1200.0, "space_freq": 2200.0}),
    ("qpsk", {"symbol_rate": 1200.0, "carrier_freq": 1500.0}),
])
def test_transmitters_send_the_power_of_a_unit_sine(modulation, tx):
    bits = list(np.random.default_rng(3).integers(0, 2, 4000))
    wave = loadgen.transmitter(modulation).modulate(tx, bits, 44100.0)
    assert wave.dtype == np.float64
    assert abs(float(np.mean(wave * wave)) - 0.5) < 0.005


def test_qpsk_recording_round_trips_through_the_port(monkeypatch):
    """A short QPSK recording of one ``qpsk_2400`` chain at 30 dB, decoded
    by the port's banked runtime on its plain CPU twins: every frame comes
    back with its payload."""
    from pymodem_tpu_torch.config import build_chain_spec
    from pymodem_tpu_torch.runtime import bank

    payloads = []
    frame_bits = loadgen._frame_bits

    def keep(tx, payload, *args):
        payloads.append(payload)
        return frame_bits(tx, payload, *args)

    monkeypatch.setattr(loadgen, "_frame_bits", keep)
    cfg = tiny_bench.qpsk2400_sweep(chains=1)
    mix = {"recordings": 1, "seconds": 3, "snr_db": [30, 30],
           "snr_bandwidth_hz": 3000,
           "frames": {"il2p": {"arrivals": "back_to_back", "gap_bits": 400,
                               "payload_bytes": [20, 30], "cycle": 2}}}
    (audio,), sent = loadgen.recordings(cfg, mix, SEED)
    chains = [build_chain_spec(44100.0, cfg["lines"][0])]
    got = bank.run_banked(chains, audio, device="cpu")[chains[0].name]
    assert sent >= 4
    # the generator drew one frame more than fitted
    assert [bytes(p.data[16:-2]) for p in got] == payloads[:sent]


@pytest.mark.parametrize("config,periods,paired", [
    ("qpsk2400", 3.0, True),
    ("qpsk2400", 6.0, False),
    ("afsk1200_ax25_sweep8", 6.0, True),
    ("afsk1200_ax25_sweep8", 9.0, False),
])
def test_lane_mismatch_pairs_within_one_byte_of_line_bits(config, periods,
                                                           paired):
    """A byte is 4 symbol periods at QPSK and 8 on a binary slicer: a
    packet further than that from the reference's does not pair."""
    from portbench.reference import compare

    cfg = _geometry_case(config)
    rate = float(cfg["sample_rate"])
    chains = decode.chains_from_lines(cfg["lines"], rate)
    sl = chains[0].slicer
    geo = decode.Geometry(n_audio=200000, trim=0, block_len=200000,
                          overlap=0, per_group=1, capacity=4096)
    data = tuple(range(30))
    address = 100000 + round(periods * sl.sample_rate / sl.symbol_rate)
    counts = compare.lane_mismatch({(0, 0): [(data, 100000)]},
                                   [[(data, address, 0)]], [(0, 0)], geo,
                                   chains)
    assert counts["total"] == 2
    assert (counts["paired"], counts["missing"]) == ((1, 0) if paired
                                                      else (0, 2))
