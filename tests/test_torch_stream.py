"""Integer stages and re-homed host codecs against pymodem_tpu, bitwise:
descramble, IL2P sync candidates and bit packing (torch), and the numpy
CRC, GF, Reed-Solomon and IL2P decoder and encoder copies."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pymodem_tpu.codecs import host as jhost
from pymodem_tpu.ops import crc as jcrc
from pymodem_tpu.ops import gf as jgf
from pymodem_tpu.ops import lfsr as jlfsr
from pymodem_tpu.ops import rs as jrs
from pymodem_tpu.ops.sync import il2p_sync_candidates
from pymodem_tpu.runtime.bank import pack_bits as jpack
from pymodem_tpu.synth import encode as jenc
from pymodem_tpu_torch.codecs import host as thost
from pymodem_tpu_torch.ops import crc as tcrc
from pymodem_tpu_torch.ops import gf as tgf
from pymodem_tpu_torch.ops import lfsr as tlfsr
from pymodem_tpu_torch.ops import rs as trs
from pymodem_tpu_torch.ops import sync as tsync
from pymodem_tpu_torch.synth import encode as tenc

# one compiled program instead of ~100 eagerly compiled small ops
jsync = jax.jit(il2p_sync_candidates, static_argnums=1)


@pytest.mark.parametrize("polys,inverts", [
    ((0x3, 0x3, 0x3), (False, False, False)),
    ((0x3, 0x3, 0x211), (False, True, False)),
    ((0, 0x63003, 0x3, 0x21), (True, False, True, True)),
    ((0x1, 0), (False, False)),
])
def test_descramble_bytes_multi_bitwise(polys, inverts, rng):
    data = rng.integers(0, 256, (len(polys), 3, 50)).astype(np.uint8)
    want = np.asarray(jax.jit(jlfsr.descramble_bytes_multi,
                              static_argnums=(1, 2))(jnp.asarray(data), polys,
                                                     inverts))
    got = tlfsr.descramble_bytes_multi(torch.from_numpy(data), polys, inverts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_np_descramble_bytes_bitwise(rng):
    data = rng.integers(0, 256, 40).astype(np.uint8)
    for poly, inv, seed in ((0x3, False, 0), (0x211, False, 0x1F0),
                            (0x63003, True, 0)):
        np.testing.assert_array_equal(
            tlfsr.np_descramble_bytes(data, poly, inv, seed),
            jlfsr.np_descramble_bytes(data, poly, inv, seed))


@pytest.mark.parametrize("tolerance", [0, 2])
def test_sync_candidates_and_pack_bits_bitwise(tolerance, rng):
    data = rng.integers(0, 256, (2, 3, 64)).astype(np.uint8)
    # plant both syncwords (and a 1-bit-off copy) at byte and bit offsets
    frame = jenc.il2p_frame("KI5ABC", "N0CALL", b"hello")
    data[0, 0, 10:13] = frame[:3]
    data[1, 2, 30:34] = [0x5D, 0x57, 0xDF, 0x7F]
    data[0, 1, 5:8] = [0xF1, 0x5E, 0x49]
    want = np.asarray(jsync(jnp.asarray(data), tolerance))
    got = tsync.il2p_sync_candidates(torch.from_numpy(data), tolerance)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() >= 2
    np.testing.assert_array_equal(tsync.pack_bits(got).numpy(),
                                  np.asarray(jpack(jnp.asarray(want))))


def test_crc_and_gf_bitwise(rng):
    np.testing.assert_array_equal(tcrc.CRC_TABLE, jcrc.CRC_TABLE)
    for n in (0, 1, 17, 300):
        data = rng.integers(0, 256, n).astype(np.uint8)
        assert tcrc.np_crc16(data) == jcrc.np_crc16(data)
        if n > 2:
            assert tcrc.np_check_packet(data) == jcrc.np_check_packet(data)
            assert tcrc.np_check_packet(data, 3) == \
                jcrc.np_check_packet(data, 3)
        a, b = list(data), list(data)
        tcrc.np_append_crc(a)
        jcrc.np_append_crc(b)
        assert a == b
    for f in ("antilog", "log", "inverse"):
        np.testing.assert_array_equal(getattr(tgf.GF256, f),
                                      getattr(jgf.GF256, f))
    a, b = rng.integers(0, 256, (2, 100))
    np.testing.assert_array_equal(tgf.np_gf_mul(tgf.GF256, a, b),
                                  jgf.np_gf_mul(jgf.GF256, a, b))


@pytest.mark.parametrize("code", ["header", "block"])
def test_rs_encode_decode_bitwise(code, rng):
    tcode, jcode, k = ((trs.RS_HEADER, jrs.RS_HEADER, 13) if code == "header"
                       else (trs.RS_BLOCK, jrs.RS_BLOCK, 100))
    np.testing.assert_array_equal(tcode.genpoly, jcode.genpoly)
    for n_err in (0, 1, tcode.num_roots // 2, tcode.num_roots // 2 + 2):
        for min_distance in (0, 1):
            data = rng.integers(0, 256, k)
            word = trs.rs_encode_np(tcode, data)
            np.testing.assert_array_equal(word, jrs.rs_encode_np(jcode, data))
            pos = rng.choice(len(word), n_err, replace=False)
            word[pos] ^= rng.integers(1, 256, n_err)
            a, b = word.copy(), word.copy()
            ra = trs.rs_decode_np(tcode, a, len(a), min_distance)
            rb = jrs.rs_decode_np(jcode, b, len(b), min_distance)
            assert ra == rb
            np.testing.assert_array_equal(a, b)


def _il2p_stream(rng, n_frames=4, corrupt=True):
    """Descrambled byte stream of IL2P frames with idle fill between them,
    some frames with injected byte errors (correctable and not)."""
    out = [0x55] * 7
    for i in range(n_frames):
        payload = bytes(rng.integers(0x20, 0x7F, 20 + 30 * i).astype(np.uint8))
        frame = np.array(jenc.il2p_frame("KI5ABC", "N0CALL", payload))
        assert list(frame) == tenc.il2p_frame("KI5ABC", "N0CALL", payload)
        if corrupt and i % 2:
            pos = rng.choice(np.arange(20, len(frame) - 4), 2 * i - 1,
                             replace=False)
            frame[pos] ^= rng.integers(1, 256, pos.size)
        out += list(frame) + [0x55] * int(rng.integers(3, 9))
    data = np.array(out, np.uint8)
    return data, np.arange(1, len(data) + 1) * 27


@pytest.mark.parametrize("with_candidates", [False, True])
def test_il2p_decoder_bitwise(with_candidates, rng):
    data, addr = _il2p_stream(rng)
    cands = None
    if with_candidates:
        sync = tsync.il2p_sync_candidates(torch.from_numpy(data))
        cands = np.flatnonzero(sync.numpy())
    for tol in (0, 1):
        want = jhost.il2p_decode_host(data, addr, "x", sync_tolerance=tol,
                                      sync_candidates=cands)
        got = thost.il2p_decode_host(data, addr, "x", sync_tolerance=tol,
                                     sync_candidates=cands)
        assert len(want) >= 2
        assert [(p.data, p.streamaddress, p.bytes_corrected) for p in got] \
            == [(p.data, p.streamaddress, p.bytes_corrected) for p in want]
    first = data[:4]
    assert thost.il2p_seeded_sync_possible(first) == \
        jhost.il2p_seeded_sync_possible(first)
    batch = data[: 4 * 6].reshape(2, 3, 4)
    np.testing.assert_array_equal(thost.il2p_seeded_sync_any(batch, 1),
                                  jhost.il2p_seeded_sync_any(batch, 1))
