"""Kernel K1's plain twin and the compaction stage against pymodem_tpu.

The binary slicer is compare/select/shift arithmetic only, so the twin must
equal the JAX scan (``ops.slicers.binary_slice``) and the Pallas kernel
(``binary_slice_lanes_pallas``, run in interpret mode on the CPU as the
JAX package's own tests run it) bitwise, at window 1 and window 8, and the
compaction must equal ``compact_bytes`` / ``compact_windowed`` bitwise.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pymodem_tpu.ops import slicers as jsl
from pymodem_tpu.ops.pallas_slicers import binary_slice_lanes_pallas
from pymodem_tpu_torch.ops import slicers as tsl

L, T = 6, 700


def _lanes(rng):
    """(L, T) f32 lanes with slicer-like structure (symbol runs + noise)
    and (2, L) f32 rows (sps, lock_rate) at several rates."""
    sps = np.array([26.666666, 8.0, 26.666666, 12.5, 40.0, 6.0], np.float32)
    lock = np.array([0.75, 0.9, 0.6, 0.8, 0.75, 0.88], np.float32)
    x = np.empty((L, T), np.float32)
    for i in range(L):
        sym = rng.integers(0, 2, T // int(sps[i]) + 2) * 2.0 - 1.0
        idx = (np.arange(T) / sps[i]).astype(np.int64)
        x[i] = sym[idx] + 0.4 * rng.standard_normal(T)
    return x, np.stack([sps, lock])


@pytest.mark.parametrize("window", [1, 8])
def test_twin_matches_pallas_kernel_bitwise(window, rng):
    x, lp = _lanes(rng)
    want = np.asarray(binary_slice_lanes_pallas(jnp.asarray(x),
                                                jnp.asarray(lp),
                                                window=window))
    got = tsl.binary_slice_lanes(torch.from_numpy(x), torch.from_numpy(lp),
                                 window=window)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want & 0x100).any()  # the lanes do emit bytes


@pytest.mark.parametrize("window", [1, 8])
def test_twin_matches_scan_and_compaction_bitwise(window, rng):
    x, lp = _lanes(rng)
    cap = 64
    enc = tsl.binary_slice(torch.from_numpy(x), torch.from_numpy(lp), window)
    for i in range(L):
        scan = jsl.binary_slice(jnp.asarray(x[i]), jnp.float32(lp[0, i]),
                                jnp.float32(lp[1, i]))
        want = jsl.compact_bytes(scan, cap, window)
        if window == 1:
            valid, byte = tsl.decode_emissions(enc[i])
            np.testing.assert_array_equal(valid.numpy(),
                                          np.asarray(scan.valid))
            got = tsl.compact_bytes(tsl.SlicerOut(valid, byte), cap, window)
        else:
            got = tsl.compact_windowed(enc[i], window, cap)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [1, 4, 16])
def test_compaction_matches_jax_bitwise(window, rng):
    """Batched (C, B, N) compaction, including rows whose emissions
    overflow the capacity (dropped slots, full count kept)."""
    C, B, N = 2, 3, 400
    valid = np.zeros((C, B, N), bool)
    for c in range(C):
        for b in range(B):
            n = 5 + 20 * (c * B + b)  # up to 105: past the capacity
            pos = rng.choice(N // window, size=min(n, N // window),
                             replace=False) * window
            valid[c, b, pos + rng.integers(0, window, pos.size)] = True
    byte = rng.integers(0, 256, (C, B, N)).astype(np.uint8)
    cap = min(48, N // window // 2)
    out = tsl.compact_bytes(
        tsl.SlicerOut(torch.from_numpy(valid), torch.from_numpy(byte)),
        cap, window)
    want = jax.jit(jax.vmap(jax.vmap(lambda v, b: jsl.compact_bytes(
        jsl.SlicerOut(v, b), cap, window))))(jnp.asarray(valid),
                                              jnp.asarray(byte))
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(out[2].max()) > cap

    if window > 1:
        # the kernel's windowed code of the same emissions
        v = valid.reshape(C, B, -1, window)
        pos = np.argmax(v, axis=-1)
        b = np.take_along_axis(byte.reshape(C, B, -1, window),
                               pos[..., None], -1)[..., 0].astype(np.int32)
        enc = np.where(v.any(-1), (pos << 16) | 0x100 | b, 0).astype(np.int32)
        got = tsl.compact_windowed(torch.from_numpy(enc), window, cap)
        want = jax.jit(jax.vmap(jax.vmap(lambda e: jsl.compact_windowed(
            e, window, cap))))(jnp.asarray(enc))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_safe_compact_window_matches():
    for sps in (6.0, 8.0, 26.666666, 40.0, 160.0, 1000.0):
        for lock in (0.6, 0.75, 0.9):
            for bps in (1, 2):
                assert tsl.safe_compact_window(sps, lock, bps) == \
                    jsl.safe_compact_window(sps, lock, bps)


def test_lane_rows_takes_strided_rows_as_they_lie():
    """K1 and K8 take rows of unit stride that need not follow one another:
    a view of rows a multiple of 4 floats apart goes to the kernels as it
    lies, another through one padded copy of the same values."""
    from pymodem_tpu_torch import _ext

    view = torch.arange(3 * 132, dtype=torch.float32).reshape(3, 132)[:, :130]
    copies = _ext.lane_rows.copies
    assert _ext.rows_aligned(view) and _ext.lane_rows(view) is view
    odd = torch.arange(3 * 131, dtype=torch.float32).reshape(3, 131)[:, :130]
    rows = _ext.lane_rows(odd)
    assert not _ext.rows_aligned(odd)
    assert _ext.lane_rows.copies == copies + 1
    assert rows.stride(0) == 132 and torch.equal(rows[:, :130], odd)
