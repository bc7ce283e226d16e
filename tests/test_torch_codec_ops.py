"""The device codec's ops in the port against pymodem_tpu, on the CPU:
GF(256) multiply, shifted row windows, the seeded descramble, the masked
CRC-16 and the batched Reed-Solomon decoder.

Inputs come from numpy seeds; the same arrays go through the JAX function
and the port's.  Tolerance: bitwise everywhere (integer stages).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pymodem_tpu.ops import bits as jbits
from pymodem_tpu.ops import crc as jcrc
from pymodem_tpu.ops import gf as jgf
from pymodem_tpu.ops import lfsr as jlfsr
from pymodem_tpu.ops import rs as jrs
from pymodem_tpu_torch.ops import bits as tbits
from pymodem_tpu_torch.ops import crc as tcrc
from pymodem_tpu_torch.ops import gf as tgf
from pymodem_tpu_torch.ops import lfsr as tlfsr
from pymodem_tpu_torch.ops import rs as trs


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want), \
        np.argwhere(got.numpy() != want)[:8]


def test_gf_mul_all_pairs():
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    antilog, log, _ = jgf.jnp_tables(jgf.GF256)
    want = jgf.gf_mul(antilog, log, jnp.asarray(a), jnp.asarray(b))
    t_antilog, t_log, t_inv = tgf.torch_tables(tgf.GF256, "cpu")
    got = tgf.gf_mul(t_antilog, t_log, torch.from_numpy(a),
                     torch.from_numpy(b))
    _equal(got, want)
    _equal(got, jgf.np_gf_mul(jgf.GF256, a, b))
    _equal(t_inv, jgf.GF256.inverse)


def test_bit_packing_matches_jax(rng):
    data = rng.integers(0, 256, (3, 40), dtype=np.uint8)
    bits = tbits.bytes_to_bits_msb(torch.from_numpy(data))
    _equal(bits, jbits.bytes_to_bits_msb(jnp.asarray(data)))
    _equal(tbits.bits_to_bytes_msb(bits), data)
    for k in (0, 1, 7, 9):
        _equal(tbits.shift_right_zero_fill(bits, k),
               jbits.shift_right_zero_fill(jnp.asarray(bits.numpy()), k))


@pytest.mark.parametrize("width", [4, 37, 300])
def test_shifted_row_windows_match_jax(rng, width):
    """take_rows_shifted / place_rows_shifted with shifts of 0, W0 and past
    either end (clamped, as the JAX package's rolls clamp them)."""
    R, W0 = 40, 90
    rows = rng.integers(0, 256, (R, W0), dtype=np.uint8)
    shift = rng.integers(-20, W0 + 40, R).astype(np.int32)
    shift[:4] = (0, W0, W0 + 7, -3)
    _equal(tbits.take_rows_shifted(torch.from_numpy(rows),
                                   torch.from_numpy(shift), width),
           jbits.take_rows_shifted(jnp.asarray(rows), jnp.asarray(shift),
                                   width))
    place_w = max(width, W0)
    pshift = rng.integers(-20, place_w + 40, R).astype(np.int32)
    pshift[:4] = (0, place_w - 1, place_w + 5, -3)
    # rows with a zero tail (as the codec masks them) and full rows, whose
    # placement wraps round the buffer's end
    for r in (np.where(np.arange(W0) < 50, rows, 0).astype(np.uint8), rows):
        _equal(tbits.place_rows_shifted(torch.from_numpy(r),
                                        torch.from_numpy(pshift), place_w),
               jbits.place_rows_shifted(jnp.asarray(r), jnp.asarray(pshift),
                                        place_w))


@pytest.mark.parametrize("n", [1, 2, 13, 255])
def test_seeded_descramble_matches_jax(rng, n):
    """The IL2P block descramble: poly 0x211, register seeded 0x1F0,
    with and without the output invert, on a batch of rows."""
    data = rng.integers(0, 256, (4, n), dtype=np.uint8)
    for invert in (False, True):
        got = tlfsr.descramble_bytes(torch.from_numpy(data), 0x211,
                                     invert=invert, seed=0x1F0)
        _equal(got, jlfsr.descramble_bytes(jnp.asarray(data), 0x211,
                                           invert=invert, seed=0x1F0))
        _equal(got[0], jlfsr.np_descramble_bytes(data[0], 0x211,
                                                 invert=invert, seed=0x1F0))


def test_crc16_masked_matches_jax_and_host(rng):
    """Lengths 0, 1, the buffer's length, past it, and random; chunked
    (``chunk_size`` below the batch) and not."""
    L = 70
    data = rng.integers(0, 256, (300, L), dtype=np.uint8)
    length = rng.integers(0, L + 1, 300).astype(np.int32)
    length[:5] = (0, 1, L, L - 1, L + 9)
    want = jcrc.crc16_masked(jnp.asarray(data), jnp.asarray(length))
    got = tcrc.crc16_masked(torch.from_numpy(data), torch.from_numpy(length))
    _equal(got, want)
    _equal(tcrc.crc16_masked(torch.from_numpy(data),
                             torch.from_numpy(length), chunk_size=64), want)
    host = [jcrc.np_crc16(data[i, : min(length[i], L)]) for i in range(300)]
    _equal(got, np.asarray(host))
    # batch dims and a scalar length broadcast
    got2 = tcrc.crc16_masked(torch.from_numpy(data.reshape(3, 100, L)),
                             torch.tensor(17))
    _equal(got2, jcrc.crc16_masked(jnp.asarray(data.reshape(3, 100, L)),
                                   jnp.asarray(17)))


def _rs_batch(rng, num_roots, B, L):
    """B codewords of random block sizes (17-255 for 16 roots, 15 for the
    header code) with 0 to 9 byte errors each, junk past each block."""
    code = trs.make_rs(0, num_roots)
    data = rng.integers(0, 256, (B, L)).astype(np.int32)
    bs = np.zeros(B, np.int32)
    for i in range(B):
        n = 15 if num_roots == 2 else int(rng.integers(17, 256))
        cw = trs.rs_encode_np(code, rng.integers(0, 256, n - num_roots))
        ne = int(rng.integers(0, 10))
        pos = rng.choice(n, min(ne, n), replace=False)
        cw[pos] ^= rng.integers(1, 256, len(pos))
        data[i, :n] = cw
        bs[i] = n
    return data, bs


@pytest.mark.parametrize(
    "num_roots,B,L,min_distance,fail_budget",
    [(16, 300, 255, 0, None), (16, 300, 255, 1, 64), (2, 300, 15, 0, None),
     (2, 300, 15, 1, 64), (16, 2500, 255, 0, 512)],
    ids=["16roots", "16roots_md1_split", "2roots", "2roots_md1_split",
         "16roots_2500rows_split"])
def test_rs_decode_matches_jax(rng, num_roots, B, L, min_distance,
                               fail_budget):
    """rs_decode against rs_decode_jax: data, results and (with the
    syndrome-zero split) overflow flags.  The 2500-row batch runs as two
    chunks, the second padded with block_size-1 rows, and its 512-row
    budget overflows in the first chunk."""
    data, bs = _rs_batch(rng, num_roots, B, L)
    want = jrs.rs_decode_jax(jnp.asarray(data), jnp.asarray(bs),
                             num_roots=num_roots, min_distance=min_distance,
                             fail_budget=fail_budget)
    got = trs.rs_decode(torch.from_numpy(data), torch.from_numpy(bs),
                        num_roots, min_distance=min_distance,
                        fail_budget=fail_budget)
    assert len(got) == len(want) == (2 if fail_budget is None else 3)
    for g, w in zip(got, want):
        _equal(g, w)
    res = got[1].numpy()
    assert (res < 0).any() and (res == 0).any()
    assert (res > 0).any() == (num_roots // 2 > min_distance)
    if fail_budget is not None:  # more corrupt rows than the budget
        assert got[2].any()
    # every row against the host decoder (rows past a split budget are
    # left for the caller, as overflow says)
    for i in range(0, B, 97):
        if fail_budget is not None and got[2][i]:
            continue
        block = data[i].copy()
        r = trs.rs_decode_np(trs.make_rs(0, num_roots), block, int(bs[i]),
                             min_distance)
        assert r == res[i]
        assert np.array_equal(block[: bs[i]], got[0][i, : bs[i]].numpy())
