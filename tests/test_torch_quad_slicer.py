"""Kernel K7's plain twin (the quadrature slicer) against pymodem_tpu.

The slicer is compare/select/shift arithmetic only, so the twin must equal
the Pallas kernel (``quadrature_slice_lanes_pallas``, in interpret mode on
the CPU, as the JAX package's own tests run it) and the scan
(``ops.slicers.quadrature_slice``) through compaction bitwise, for 2 bits
per decision (QPSK demap, 4-bit state) and 1 (BPSK demap (0, 0, 1, 1),
2-bit state), at window 1 and window 8.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pymodem_tpu.config import _BPSK_DEMAP, _QPSK_DEMAP
from pymodem_tpu.ops import slicers as jsl
from pymodem_tpu.ops.pallas_slicers import quadrature_slice_lanes_pallas
from pymodem_tpu_torch.ops import slicers as tsl

L, T = 5, 1200
# (demap, state_mask, bits per decision)
MODES = {"qpsk": (_QPSK_DEMAP, 0xF, 2), "bpsk": (_BPSK_DEMAP, 0x3, 1)}


def _lanes(rng):
    """(L, T) f32 I and Q lanes with symbol runs and noise, (2, L) rows
    (sps, lock_rate) at several rates."""
    sps = np.array([36.75, 16.0, 6.6666665, 26.666666, 12.0], np.float32)
    lock = np.array([0.9, 0.815, 0.9, 0.99, 0.75], np.float32)
    i_l = np.empty((L, T), np.float32)
    q_l = np.empty((L, T), np.float32)
    for k in range(L):
        idx = (np.arange(T) / sps[k]).astype(np.int64)
        for out in (i_l, q_l):
            sym = rng.integers(0, 2, idx[-1] + 1) * 2.0 - 1.0
            out[k] = sym[idx] + 0.4 * rng.standard_normal(T)
    return i_l, q_l, np.stack([sps, lock])


@pytest.mark.parametrize("window", [1, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_twin_matches_pallas_kernel_bitwise(mode, window, rng):
    demap, mask, bps = MODES[mode]
    i_l, q_l, lp = _lanes(rng)
    want = np.asarray(quadrature_slice_lanes_pallas(
        jnp.asarray(i_l), jnp.asarray(q_l), jnp.asarray(lp), demap, mask,
        bps, window=window))
    got = tsl.quadrature_slice_lanes(torch.from_numpy(i_l),
                                     torch.from_numpy(q_l),
                                     torch.from_numpy(lp), demap, mask, bps,
                                     window=window)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want & 0x100).any()  # the lanes do emit bytes


@pytest.mark.parametrize("window", [1, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_twin_matches_scan_and_compaction_bitwise(mode, window, rng):
    demap, mask, bps = MODES[mode]
    i_l, q_l, lp = _lanes(rng)
    cap = 96
    enc = tsl.quadrature_slice(torch.from_numpy(i_l), torch.from_numpy(q_l),
                               torch.from_numpy(lp), demap, mask, bps, window)
    for k in range(L):
        scan = jsl.quadrature_slice(
            jnp.asarray(i_l[k]), jnp.asarray(q_l[k]), jnp.float32(lp[0, k]),
            jnp.float32(lp[1, k]), jnp.asarray(demap, jnp.int32), mask, bps)
        want = jsl.compact_bytes(scan, cap, window)
        if window == 1:
            valid, byte = tsl.decode_emissions(enc[k])
            np.testing.assert_array_equal(valid.numpy(),
                                          np.asarray(scan.valid))
            np.testing.assert_array_equal(
                byte.numpy()[valid.numpy()],
                np.asarray(scan.byte)[np.asarray(scan.valid)])
            got = tsl.compact_bytes(tsl.SlicerOut(valid, byte), cap, window)
        else:
            got = tsl.compact_windowed(enc[k], window, cap)
        assert int(want[2]) > 0
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 16)
    lp = torch.ones(2, 2)
    with pytest.raises(ValueError, match="demap"):
        tsl.quadrature_slice_lanes(x, x, lp, (0, 0, 1, 1), 0xF, 2)
    with pytest.raises(ValueError, match="demap"):
        tsl.quadrature_slice_lanes(x, x, lp, _QPSK_DEMAP, 0xF, 3)
    with pytest.raises(ValueError, match="demap"):  # entries are 2 bits
        tsl.quadrature_slice_lanes(x, x, lp, (0, 0, 1, 4), 0x3, 1)
    with pytest.raises(ValueError, match="window"):
        tsl.quadrature_slice_lanes(x, x, lp, _QPSK_DEMAP, 0xF, 2, window=6)
    with pytest.raises(ValueError, match="shapes"):
        tsl.quadrature_slice_lanes(x, x[:, :8], lp, _QPSK_DEMAP, 0xF, 2)
    k7 = tsl.quadrature_slice_lanes.launches
    tsl.quadrature_slice_lanes(x, x, lp, _QPSK_DEMAP, 0xF, 2)
    assert tsl.quadrature_slice_lanes.launches == k7  # the twin ran
    meta = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsl.quadrature_slice_lanes(meta, meta, lp.to("meta"), _QPSK_DEMAP,
                                   0xF, 2)


@pytest.mark.parametrize("T", [16, 389])
def test_lane_rows_hands_the_kernels_aligned_rows(T):
    """K6 and K7 copy rows by 16-byte bulk copies: ``lane_rows`` keeps a
    contiguous tensor with aligned rows as it is and copies any other into
    zero-padded rows a multiple of 4 floats long, its samples unchanged."""
    from pymodem_tpu_torch import _ext

    x = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (3, T)).astype(np.float32)).clone()
    offset = torch.empty(3 * T + 1)[1:].view(3, T).copy_(x)
    for t in (x, offset):
        copies = _ext.lane_rows.copies
        rows = _ext.lane_rows(t)
        aligned = T % 4 == 0 and t is x
        assert _ext.lane_rows.copies == copies + (not aligned)
        assert _ext.rows_aligned(t) == aligned
        assert (rows is t) == aligned
        assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
        assert rows.shape == (3, -(-T // 4) * 4)
        assert torch.equal(rows[:, :T], x)
        assert not rows[:, T:].any()
