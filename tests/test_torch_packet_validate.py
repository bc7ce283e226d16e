"""The port's batched packet validation (``packets.validate_packets``, one
CRC and header pass over all of a recording's packets, and the one-row
calls built on it) against the JAX package's per-packet
``Packet.validate`` and ``np_check_packet``: carried and calculated CRC,
``valid_crc`` and ``valid_header``, bit for bit and with the same Python
types, and the reports rendered from both packages' aggregates."""

import numpy as np
import pytest

from pymodem_tpu import packets as jpk
from pymodem_tpu.ops import crc as jcrc
from pymodem_tpu.synth.encode import ax25_ui_frame
from pymodem_tpu_torch import packets as tpk
from pymodem_tpu_torch.ops import crc as tcrc

FIELDS = ("carried_crc", "calculated_crc", "valid_crc", "valid_header")


def _as(kind, data):
    return np.asarray(data, dtype=np.uint8) if kind == "array" else list(data)


def _check(datas, kind, n_chains=3):
    """Validate ``datas`` in one port aggregate, spread over ``n_chains``
    chains with an empty chain between them, and hold every packet to the
    JAX package's per-packet validation and ``np_check_packet``."""
    ours = [tpk.Packet(data=_as(kind, d)) for d in datas]
    aggregate = tpk.PacketAggregate()
    for chain in np.array_split(np.arange(len(ours)), n_chains):
        aggregate.add([ours[i] for i in chain])
        aggregate.add([])
    assert aggregate.validate_all() == sum(len(d) for d in datas)
    for d, got in zip(datas, ours):
        want = jpk.Packet(data=list(d))
        want.validate()
        for name in FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            assert a == b and type(a) is type(b), (name, len(d), a, b)
        check = jcrc.np_check_packet(np.asarray(d))
        assert (got.carried_crc, got.calculated_crc, got.valid_crc) == check
        one = tpk.Packet(data=_as(kind, d))
        one.validate()
        assert [getattr(one, f) for f in FIELDS] == \
            [getattr(want, f) for f in FIELDS]
        assert tpk.printable_header(_as(kind, d)) is want.valid_header
    return ours


def _with_crc(data):
    data = list(data[:-2])
    tcrc.np_append_crc(data)
    return data


def _printable(rng, n):
    """``n`` bytes whose first 7 pass the header check."""
    data = rng.integers(0, 256, n).tolist()
    data[:7] = (2 * rng.integers(32, 127, min(n, 7)) + rng.integers(0, 2)).tolist()
    return data


@pytest.mark.parametrize("kind", ["list", "array"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_packets_match_per_packet_validation(seed, kind):
    """Lengths 2-1,100 in one pass, every third with a good CRC appended
    by ``np_append_crc``, every other one with a printable header."""
    rng = np.random.default_rng(seed)
    datas = []
    for i, n in enumerate(rng.integers(2, 1101, 48).tolist()):
        data = _printable(rng, n) if i % 2 else rng.integers(0, 256, n).tolist()
        datas.append(_with_crc(data) if i % 3 == 0 else data)
    ours = _check(datas, kind)
    assert any(p.valid_crc for p in ours) and not all(p.valid_crc for p in ours)
    assert any(p.valid_header for p in ours)


@pytest.mark.parametrize("kind", ["list", "array"])
@pytest.mark.parametrize("length", [2, 15, 16, 17])
def test_edge_lengths(length, kind):
    """At and around the header check's 16 bytes and the 2 CRC bytes, good
    and bad CRCs, printable and not, among longer packets."""
    rng = np.random.default_rng(length)
    datas = []
    for _ in range(4):
        for data in (_printable(rng, length), rng.integers(0, 256, length).tolist()):
            datas += [data, _with_crc(data)]
    datas.append(_with_crc(_printable(rng, 300)))
    ours = _check(datas, kind, n_chains=2)
    assert any(p.valid_crc for p in ours[:-1])
    assert all(not p.valid_header for p in ours[:-1]) == (length <= 15)


@pytest.mark.parametrize("where", ["address", "after"])
@pytest.mark.parametrize("char", [0, 31, 32, 126, 127])
def test_header_characters(char, where):
    """A character (byte shifted right once) of 0, 31, 32, 126 or 127 at
    each of positions 0-6, which the check constrains, or at position 7,
    which it does not, with either low bit."""
    rng = np.random.default_rng(char)
    positions = range(7) if where == "address" else (7,)
    datas = []
    for pos in positions:
        for low in (0, 1):
            data = _printable(rng, 40)
            data[pos] = 2 * char + low
            datas.append(_with_crc(data))
    ours = _check(datas, "list")
    printable = char == 0 or 32 <= char <= 126 or where == "after"
    assert all(p.valid_header is printable for p in ours)


@pytest.mark.parametrize("kind", ["list", "array"])
@pytest.mark.parametrize("max_distance", [0, 3])
def test_np_check_packet_near_misses(max_distance, kind):
    """Carried CRCs 0-5 bits off the calculated one, one packet at a time
    and in one batch."""
    rng = np.random.default_rng(max_distance)
    datas = []
    for n_bits in range(6):
        for _ in range(3):
            data = _with_crc(rng.integers(0, 256, int(rng.integers(4, 80))).tolist())
            flip = sum(1 << int(b) for b in rng.choice(16, n_bits, replace=False))
            data[-2] ^= flip & 0xFF
            data[-1] ^= flip >> 8
            datas.append(_as(kind, data))
    want = [jcrc.np_check_packet(np.asarray(d), max_distance) for d in datas]
    got = [tcrc.np_check_packet(d, max_distance) for d in datas]
    assert got == want
    assert [tuple(map(type, g)) for g in got] == [(int, int, bool)] * len(datas)
    carried, calculated, valid = tcrc.np_check_packets(datas, max_distance)
    assert list(zip(carried.tolist(), calculated.tolist(), valid.tolist())) == want
    assert 0 < sum(v for _, _, v in want) < len(want)
    for d in datas:
        assert tcrc.np_crc16(d) == jcrc.np_crc16(np.asarray(d, dtype=np.uint8))


@pytest.mark.parametrize("chains", [0, 3])
def test_an_aggregate_without_packets_makes_no_numpy_call(chains, monkeypatch):
    def refuse(*_):
        raise AssertionError("numpy pass over no packets")

    monkeypatch.setattr(tpk, "gather_rows", refuse)
    aggregate = tpk.PacketAggregate()
    for _ in range(chains):
        aggregate.add([])
    assert aggregate.validate_all() == 0


@pytest.mark.parametrize("length", [0, 1])
def test_a_packet_without_crc_bytes_raises(length):
    """As today's per-packet check does, for lengths 0 and 1: no result is
    made up for them."""
    data = list(range(length))
    with pytest.raises(IndexError):
        jcrc.np_check_packet(np.asarray(data))
    with pytest.raises(IndexError):
        tcrc.np_check_packet(data)
    aggregate = tpk.PacketAggregate()
    aggregate.add([tpk.Packet(data=[1, 2, 3, 4]), tpk.Packet(data=data)])
    with pytest.raises(IndexError):
        aggregate.validate_all()


@pytest.mark.parametrize("kind", ["list", "array"])
def test_reports_equal_the_jax_package(kind):
    """``raw`` and ``decoded_headers`` reports from both packages'
    aggregates over the same packets: frames heard by several chains at
    nearby addresses, bad CRCs and bad headers among them."""
    rng = np.random.default_rng(7)
    frames = [ax25_ui_frame(f"N{i}CALL", f"K{i}ABC",
                            bytes(rng.integers(32, 127, 20 + 7 * i).tolist()))
              for i in range(6)]
    records = []
    for chain in range(3):
        chain_records = []
        for i, frame in enumerate(frames):
            data = list(frame)
            if (i + chain) % 4 == 0:
                data[-1] ^= 0x10
            if (i + 2 * chain) % 5 == 0:
                data[2] = 2 * 20
            chain_records.append((data, 1000 * i + 3 * chain, f"chain{chain}"))
        records.append(chain_records)
    reports = []
    for pk, wrap in ((tpk, lambda d: _as(kind, d)), (jpk, list)):
        aggregate = pk.PacketAggregate()
        for chain_records in records:
            aggregate.add([pk.Packet(data=wrap(d), streamaddress=a,
                                     source_decoder=s)
                           for d, a, s in chain_records])
        aggregate.validate_all()
        aggregate.correlate(address_distance=100)
        reports.append([aggregate.render_raw_bad() + aggregate.render_report(style)
                        for style in ("raw", "decoded_headers")])
    assert reports[0] == reports[1]
    assert "bad CRC" in reports[1][0] and "bad header" in reports[1][0]
    assert "Unique, valid packets:" in reports[1][1]
