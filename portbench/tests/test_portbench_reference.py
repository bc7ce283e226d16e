"""The plain reference against synthesised frames at a tiny size, and its
control, which the check has to tell from it."""

import json

import numpy as np
import pytest

from portbench import loadgen
from portbench.reference import arith, compare, decode
from portbench.tests.tiny_bench import SRC


def _case(config, rate, seconds, snr):
    cfg = json.loads((SRC / f"configs/{config}.json").read_text())
    cfg["sample_rate"] = rate
    cfg["lines"] = cfg["lines"][:2] + cfg["lines"][-1:]
    mix = {"recordings": 1, "seconds": seconds, "snr_db": snr,
           "snr_bandwidth_hz": 3000,
           "frames": {"il2p": {"arrivals": "back_to_back", "gap_bits": 400,
                               "payload_bytes": [20, 30], "cycle": 2},
                      "ax25": {"arrivals": "load", "load": 0.5,
                               "payload_bytes": [20, 40], "cycle": 4}}}
    recs, sent = loadgen.recordings(cfg, mix, 11)
    return cfg, recs[0], sent


@pytest.mark.parametrize("config", ["afsk300_pll_sweep64", "afsk1200_ax25_sweep8"])
def test_reference_decodes_every_frame_at_high_snr(config):
    cfg, audio, sent = _case(config, 8000, 12, [30, 30])
    geo_kw = {"block_seconds": 30.0, "overlap_seconds": 0.0}
    lanes = [(0, 0), (1, 0)]
    ref = decode.decode_lanes(cfg["lines"], 8000, audio, lanes, geo_kw,
                              workers=1)
    chains = decode.chains_from_lines(cfg["lines"], 8000)
    for lane in lanes:
        assert len(ref[lane]) >= sent, (lane, len(ref[lane]), sent)
    rep = compare.reports(cfg["lines"], chains,
                          [[(d, a, 0) for d, a in ref[l]] for l in lanes], 8000)
    assert f"Unique, valid packets:  {sent}" in rep[0]


@pytest.mark.parametrize("config,cell,seconds,snr,geo_kw", [
    ("afsk1200_ax25_sweep8", "afsk1200_ax25_sweep8.busy_10min", 12, [12, 24],
     {"block_seconds": 3.0, "overlap_seconds": 1.5}),
    ("afsk300_pll_sweep64", "afsk300_pll_sweep64.quiet_hour", 20, [6, 12],
     {"block_seconds": 6.0, "overlap_seconds": 4.0}),
])
def test_control_is_told_from_the_reference(config, cell, seconds, snr,
                                            geo_kw):
    """The control (TF32 FIR operands, bfloat16 recurrences) in the
    program's place fails one of the cell's numbers at this size, where
    the reference against itself reads 0."""
    cfg, audio, _ = _case(config, 8000, seconds, snr)
    chains = decode.chains_from_lines(cfg["lines"], 8000)
    geo = decode.geometry(chains, len(audio), 8000, **geo_kw)
    lanes = [(c, b) for c in range(2) for b in range(geo.n_blocks)]
    ref = decode.decode_lanes(cfg["lines"], 8000, audio, lanes, geo_kw,
                              workers=2)
    ctl = decode.decode_lanes(cfg["lines"], 8000, audio, lanes, geo_kw,
                              precision="control", workers=2)

    def as_port(lanes_out):
        return [[(d, a, 0) for (c2, _), pk in lanes_out.items() if c2 == c
                 for d, a in pk] for c in range(2)]

    lim = json.loads((SRC / f"limits/{cell}.json").read_text())
    r_ctl = compare.readings(compare.lane_mismatch(ref, as_port(ctl), lanes,
                                                   geo, chains))
    r_ref = compare.readings(compare.lane_mismatch(ref, as_port(ref), lanes,
                                                   geo, chains))
    assert r_ref == {"packet_mismatch_pct": 0.0, "address_moved_pct": 0.0}
    assert any(v > lim[k] for k, v in r_ctl.items() if k in lim), r_ctl


def test_bf16_and_tf32_rounding():
    assert arith.bf16(1.0 + 2**-9) == 1.0
    assert arith.bf16(1.0 + 2**-7) == 1.0 + 2**-7
    x = np.asarray([1.0 + 2**-12, 1.0 + 2**-10])
    assert list(arith.round_mantissa(x, 10)) == [1.0, 1.0 + 2**-10]
    assert arith.f32(1.0 + 2**-25) == 1.0
    assert arith.f32(1.0 + 2**-23) == 1.0 + 2**-23


def test_aggregate_worked_out_again_equals_the_ports():
    """The reference's aggregate, written apart from both packages, gives
    the port's report text over packets that exercise every branch: good
    and bad CRCs and headers, frames of 15 bytes and less, each control
    and PID, duplicates across chains near and far."""
    from pymodem_tpu_torch.packets import Packet, PacketAggregate

    from portbench.reference import aggregate
    from portbench.reference.frozen.crc import np_append_crc

    rng = np.random.default_rng(7)
    controls = [0x03, 0x13, 0x6F, 0x2F, 0x43, 0x0F, 0x63, 0x87, 0xAF, 0xE3,
                0x00, 0x01, 0x10]
    pids = [0xF0, 0xCF, 0x01, 0x55, 0xFF]

    def frame():
        n_addr = 7 * int(rng.integers(2, 5))
        addr = [int(v) << 1 for v in rng.integers(0x20, 0x5B, n_addr)]
        if rng.random() < 0.2:
            addr[int(rng.integers(0, 7))] = int(rng.integers(0, 64))
        addr[-1] |= 1
        body = [controls[int(rng.integers(len(controls)))],
                pids[int(rng.integers(len(pids)))]]
        body += [int(v) for v in rng.integers(0, 256, int(rng.integers(0, 40)))]
        data = addr + body
        if rng.random() < 0.2:
            # 15 bytes or less: no header is printed
            data = data[: int(rng.integers(1, 14))]
        np_append_crc(data)
        if rng.random() < 0.2:
            data[int(rng.integers(len(data)))] ^= 1 << int(rng.integers(8))
        return data

    pool = [frame() for _ in range(60)]
    chains = []
    for c in range(5):
        chains.append([(pool[int(k)], int(rng.integers(0, 5000)),
                        int(rng.integers(0, 3)))
                       for k in rng.integers(0, len(pool), 40)])
    window = 800.0
    agg = PacketAggregate()
    for c, pk in enumerate(chains):
        agg.add([Packet(data=list(d), streamaddress=a,
                        source_decoder=f"chain {c}", bytes_corrected=k)
                 for d, a, k in pk])
    agg.validate_all()
    agg.correlate(address_distance=window)
    styles = ["raw", "decoded_headers"]
    port = [agg.render_raw_bad() + agg.render_report(s) for s in styles]
    mine = aggregate.reports(
        [[aggregate.Frame(d, a, f"chain {c}", k) for d, a, k in pk]
         for c, pk in enumerate(chains)], styles, window)
    assert agg.decoder_histogram and len(agg.unique) < sum(map(len, chains))
    assert mine == port
