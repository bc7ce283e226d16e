"""The FSK family of the port against pymodem_tpu: kernel K8's plain twin
(the four-level slicer), bank parameters, and packets end to end for the
FSK-9600 (binary slicer) and 4FSK (four-level slicer) banks.

K8's twin is compare/select/shift arithmetic plus two float forms that must
match the JAX scan's: ``|x| * 2.0 / 3.0`` (a multiply then an IEEE divide;
the Pallas kernel's ``|x| * (2.0/3.0)`` differs by an ulp on about a third
of random f32 inputs) and the ring mean as the sequential sum ``r0 + r1 +
... + r7`` over 8 (what XLA-CPU's ``jnp.sum`` of the 8-entry ring gives;
a pairwise order does not).  So twin and scan agree bitwise on noise, where
samples land within an ulp of the threshold, and on modulated 4FSK.  The
Pallas kernel in interpret mode agrees on modulated audio, where no sample
sits that close to the threshold.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pymodem_tpu import modems as jmodems
from pymodem_tpu.config import build_chain_spec as jbuild_chain_spec
from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu.ops.pallas_slicers import four_level_slice_lanes_pallas
from pymodem_tpu.ops.slicers import (
    SlicerOut,
    compact_bytes as jcompact,
    four_level_slice as jfour_level,
)
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu_torch import modems as tmodems
from pymodem_tpu_torch.config import build_chain_spec
from pymodem_tpu_torch.convert import bank_params_from_jax
from pymodem_tpu_torch.ops import slicers as tsl
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

DEMAP = (2, 0, 3, 1)  # the four-level slicer's (slicer.py:297-308)
L, T = 6, 3000


def _modulated(rng):
    """(L, T) f32 4FSK lanes: random dibits at 4800 Bd, 48 kHz, through the
    "4800" preset's input filter, each lane with its own gain and a little
    noise."""
    spec = build_chain_spec(48000.0, _line("f4", "4800", "4level", "4800"))
    taps = tmodems.build_params(spec.modem).input_lpf
    out = []
    for lane in range(L):
        dibits = rng.integers(0, 4, T // 10 + 8).tolist()
        wave = tmod.four_level_modulate(dibits, 48000.0, 4800.0)
        wave = np.convolve(wave, taps, "valid")[:T]
        out.append(wave * (0.5 + 0.3 * lane)
                   + 0.02 * rng.standard_normal(T))
    return np.ascontiguousarray(np.stack(out), np.float32)


def _noise(rng):
    return rng.standard_normal((L, T)).astype(np.float32)


def _lane_params(rng):
    sps = rng.choice([10.0, 9.7, 10.4], L).astype(np.float32)
    lock = rng.choice([0.985, 0.9], L).astype(np.float32)
    return np.stack([sps, lock])


def _scan(x, lp):
    """The JAX package's four_level_slice, lane by lane (valid, byte)."""
    outs = [jfour_level(jnp.asarray(x[i]), jnp.asarray(lp[0, i]),
                        jnp.asarray(lp[1, i]), jnp.asarray(DEMAP, jnp.int32),
                        jnp.zeros((), jnp.float32))
            for i in range(x.shape[0])]
    return (np.stack([np.asarray(o.valid) for o in outs]),
            np.stack([np.asarray(o.byte) for o in outs]))


@pytest.mark.parametrize("window", [1, 8])
@pytest.mark.parametrize("signal", ["noise", "modulated"])
def test_four_level_twin_matches_scan(rng, signal, window):
    x = _noise(rng) if signal == "noise" else _modulated(rng)
    lp = _lane_params(rng)
    valid, byte = _scan(x, lp)
    assert valid.sum() > 50  # the slicer emits on this input
    enc = tsl.four_level_slice_lanes(torch.from_numpy(x),
                                     torch.from_numpy(lp), DEMAP, window)
    if window == 1:
        out = tsl.decode_emissions(enc)
        np.testing.assert_array_equal(out.valid.numpy(), valid)
        np.testing.assert_array_equal(out.byte.numpy()[valid], byte[valid])
    cap = 512
    want = [np.asarray(v) for v in jax.vmap(
        lambda v, b: jcompact(SlicerOut(v, b), cap, window))(
            jnp.asarray(valid), jnp.asarray(byte))]
    got = (tsl.compact_windowed(enc, window, cap) if window > 1 else
           tsl.compact_bytes(tsl.decode_emissions(enc), cap))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_four_level_twin_matches_pallas_kernel(rng):
    x = _modulated(rng)
    lp = _lane_params(rng)
    for window in (1, 8):
        want = np.asarray(four_level_slice_lanes_pallas(
            jnp.asarray(x), jnp.asarray(lp), DEMAP, window=window))
        got = tsl.four_level_slice_lanes(torch.from_numpy(x),
                                         torch.from_numpy(lp), DEMAP, window)
        np.testing.assert_array_equal(got.numpy(), want)
        assert ((want & 0x100) != 0).sum() > 50


def test_four_level_wrapper_refuses_a_bad_demap():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="demap"):
        tsl.four_level_slice_lanes(x, torch.ones(2, 2), (0, 1, 2))


# ---------------------------------------------------------------------------
# Host parameters, bank parameters, end to end
# ---------------------------------------------------------------------------


def _line(name, preset, slicer, slicer_preset, poly="0x1", invert="no"):
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": "fsk", "config": preset, "options": {}},
        "slicer": {"type": slicer, "config": slicer_preset, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": poly,
                                               "invert": invert}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }


def _variant(spec, name, **modem):
    return replace(spec, name=name, modem=replace(spec.modem, **modem),
                   codec=replace(spec.codec, ident=name))


def _banks(rate, build=jbuild_chain_spec):
    """The bank shapes of the FSK family, cut to 2-3 chains: an FSK-9600
    cutoff sweep (bench.py's step, 5 Hz; G3RUH scrambler), an invert pair
    (a ``sign`` of +1 and -1 in one bank), a 9600-rrc chain, and a 4FSK
    cutoff sweep (the "4800" FSK preset with the four-level slicer at
    4800 Bd)."""
    f96 = build(rate, _line("fsk", "9600", "binary", "9600", "0x63003"))
    f4 = build(rate, _line("f4", "4800", "4level", "4800"))
    return {
        "fsk_sweep": [_variant(f96, f"c{i}",
                               input_lpf_cutoff=6000.0 + 5.0 * i)
                      for i in range(3)],
        "fsk_invert": [f96, _variant(f96, "inv", invert=True)],
        "fsk_rrc": [build(rate, _line("rrc", "9600-rrc", "binary", "9600",
                                      "0x63003"))],
        "fsk4_sweep": [_variant(f4, f"c{i}", input_lpf_cutoff=3000.0 + 5.0 * i)
                       for i in range(3)],
    }


@pytest.mark.parametrize("preset", ["9600", "4800", "9600-rrc", "4800-gauss"])
def test_host_params_match_jax(preset):
    tspec = build_chain_spec(96000.0, _line("f", preset, "binary", "9600"))
    jspec = jbuild_chain_spec(96000.0, _line("f", preset, "binary", "9600"))
    a, b = tmodems.build_params(tspec.modem), jmodems.build_params(jspec.modem)
    assert a._fields == b._fields
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", ["fsk_sweep", "fsk_invert", "fsk_rrc",
                                  "fsk4_sweep"])
def test_group_chains_matches_convert(name):
    rate = 48000.0 if name == "fsk4_sweep" else 96000.0
    chains = _banks(rate)[name]
    jbanks = jbank.group_chains(chains, jnp.float32)
    tbanks = tbank.group_chains(_banks(rate, build_chain_spec)[name], "cpu")
    assert len(jbanks) == len(tbanks) == 1
    jb, tb = jbanks[0], tbanks[0]
    assert (tb.kind, tb.trim, tb.up, tb.trim_post, tb.slicer_kind) == \
        (jb.kind, jb.trim, jb.up, jb.trim_post, jb.slicer_kind)
    assert (tb.stream_polys, tb.stream_inverts) == \
        (jb.stream_polys, jb.stream_inverts)
    want = _flat(bank_params_from_jax(jb.params, device="cpu"))
    got = _flat(tb.params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    signs = [-1.0 if c.modem.invert else 1.0 for c in chains]
    assert got["modem/sign/"].tolist() == signs
    # what the bits per decision feed: the window, the capacity, the halo
    static = jbank._slicer_static(jb)
    assert tbank.slicer_window(tb) == static["compact_window"]
    plan = tbank.default_block_plan(int(rate) * 20, tb.trim, rate, 4.0, 2.0)
    assert tbank.bank_capacity(tb, plan) == jbank.bank_capacity(jb, plan)
    c0 = tb.specs[0]
    assert tbank._chain_bit_rate(c0) == jbank._chain_bit_rate(c0)
    assert tbank._protocol_max_packet_seconds(c0) == \
        jbank._protocol_max_packet_seconds(c0)
    assert tbank.bank_auto_geometry(tb, rate, 0.1)[1] == \
        jbank.bank_auto_geometry(jb, rate, jnp.float32, 0.1)[1]
    if name == "fsk4_sweep":
        assert got["demap/"][0].tolist() == list(DEMAP)
        assert tbank._chain_bit_rate(c0) == 9600.0


def test_fsk_demod_matches_jax_per_chain():
    """The bank's one-pass demod (the sign in the taps) against the JAX
    package's per-chain FIR times sign: equal values, the same signs."""
    chains = _banks(96000.0, build_chain_spec)["fsk_invert"]
    (tb,) = tbank.group_chains(chains, "cpu")
    (jb,) = jbank.group_chains(_banks(96000.0)["fsk_invert"], jnp.float32)
    rng = np.random.default_rng(3)
    blocks = rng.standard_normal((3, 2000)).astype(np.float32)
    got = tbank.bank_basebands(tb, torch.from_numpy(blocks)).numpy()
    for c in range(2):
        cp = {"input_lpf": jb.params["modem"]["input_lpf"][c],
              "sign": jb.params["modem"]["sign"][c]}
        want = np.asarray(jbank.demod_blocks(
            "fsk", {"modem": cp}, jnp.asarray(blocks), "auto", 8))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=2e-6)
        assert np.array_equal(got[c] > 0, want > 0)
    np.testing.assert_array_equal(got[0], -got[1])


@pytest.mark.parametrize("name,rate", [("fsk_sweep", 96000.0),
                                       ("fsk4_sweep", 48000.0)])
def test_fsk_basebands_reach_the_slicers_as_they_lie(name, rate):
    """The bank hands K1 and K8 the FSK basebands' rows as the FIR's matmul
    leaves them, a multiple of its 128-sample tile apart, so the staged
    kernels copy no rows where T is not a multiple of 4; the emissions
    equal the twin's on a contiguous copy."""
    from pymodem_tpu_torch import _ext

    (bank,) = tbank.group_chains(_banks(rate, build_chain_spec)[name], "cpu")
    taps = bank.params["modem"]["input_lpf"].shape[-1]
    rng = np.random.default_rng(4)
    blocks = rng.standard_normal((2, 3002 + taps - 1)).astype(np.float32)
    bb = tbank.bank_basebands(bank, torch.from_numpy(blocks))
    C, B, L2 = bb.shape
    lanes = bb.reshape(C * B, L2)
    assert L2 % 4 != 0 and not lanes.is_contiguous()
    assert _ext.rows_aligned(lanes)
    window = tbank.slicer_window(bank)
    lp = tbank.slicer_lane_params(bank, B)
    if bank.slicer_kind == "4level":
        want = tsl.four_level_slice(lanes.contiguous(), lp,
                                    bank.specs[0].slicer.demap, window)
    else:
        want = tsl.binary_slice(lanes.contiguous(), lp, window)
    got = tbank.slice_lanes(bank, bb, window)
    assert torch.equal(got.reshape(C * B, -1), want)


def _packets(by_name):
    return {
        name: [(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
                int(p.streamaddress), int(p.bytes_corrected)) for p in pkts]
        for name, pkts in by_name.items()
    }


# The presets' own rates, 10 samples per symbol.  At half these rates every
# chain still decodes every frame cleanly, but the input filter shrinks to 8
# taps and takes the shift engine, whose multiply-adds XLA-CPU contracts
# into FMAs inside the JAX package's jitted bank step: a marginal slicer
# decision then moves by a sample and packet addresses by one.
E2E_RATES = {"fsk_sweep": 96000.0, "fsk_invert": 96000.0,
             "fsk4_sweep": 48000.0}


GEOM = dict(block_seconds=0.3, overlap_seconds=0.4)
_CASES: dict = {}


def _e2e_case(name):
    """(JAX chains, port chains, payloads sent, int16 audio) of bank
    ``name``; with the port's run_banked per codec route, each run once in
    this module."""
    if name not in _CASES:
        rate = E2E_RATES[name]
        port_chains = _banks(rate, build_chain_spec)[name]
        rng = np.random.default_rng(20261016)
        sent, x = tfx.synthesize_for_chain(port_chains[0], rate, rng,
                                           n_frames=3, size=10, gap_bits=600)
        x = tmod.to_int16(x)
        if name == "fsk_invert":  # the recording, then its negative
            x = np.concatenate([x, -x])
            sent = sent + sent
        _CASES[name] = (_banks(rate)[name], port_chains, sent, x, {})
    return _CASES[name]


def _port_run(name, codec):
    _, port_chains, _, x, runs = _e2e_case(name)
    if codec not in runs:
        runs[codec] = tbank.run_banked(port_chains, x, codec=codec,
                                       device="cpu", **GEOM)
    return runs[codec]


@pytest.mark.parametrize("name", sorted(E2E_RATES))
def test_run_banked_matches_jax(name):
    chains, port_chains, sent, x, _ = _e2e_case(name)
    want = jbank.run_banked(chains, x, dtype=jnp.float32, codec="host",
                            **GEOM)
    got = _port_run(name, "host")
    assert _packets(got) == _packets(want)
    per_chain = [[bytes(p.data[16:-2]) for p in got[c.name]]
                 for c in port_chains]
    assert per_chain == [sent] * len(port_chains)
    assert all(p.bytes_corrected == 0 for pk in got.values() for p in pk)


@pytest.mark.parametrize("name", sorted(E2E_RATES))
def test_device_codec_matches_jax_and_host(name):
    """The device IL2P codec route (the default): packets equal the JAX
    package's device route and the port's host route."""
    chains, port_chains, sent, x, _ = _e2e_case(name)
    want = jbank.run_banked(chains, x, dtype=jnp.float32, codec="device",
                            **GEOM)
    got = _port_run(name, "device")
    assert _packets(got) == _packets(want)
    assert _packets(got) == _packets(_port_run(name, "host"))
    per_chain = [[bytes(p.data[16:-2]) for p in got[c.name]]
                 for c in port_chains]
    assert per_chain == [sent] * len(port_chains)
