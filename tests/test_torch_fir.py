"""Port FIR engines against pymodem_tpu.dsp.fir on the same inputs.

f64: ``conv1d`` against the JAX ``direct`` engine to 1e-12 relative (both
are exact-order-free dot products in double).  f32: against the JAX
``shift`` (<= 8 taps) and banded-matmul (longer taps) engines.  The sums
run in another order, and XLA:CPU contracts multiply-adds into FMAs, so the
bound is stated against the magnitude of the terms summed:
|port - jax| <= 1e-6 * sum_j |x taps_j| (~8 f32 ulps of that scale).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pymodem_tpu.dsp import fir as jfir
from pymodem_tpu.dsp import window_design as wd
from pymodem_tpu_torch.dsp import fir as tfir

# the tap counts the AFSK-300 slice runs: correlators, output LPFs, BPF
TAPS = (8, 67, 133, 187)


def _taps(t):
    return wd.lowpass_taps(t, 240.0, 8000.0) if t > 8 else \
        np.cos(np.arange(t) * 0.7)


def _scale(x, taps):
    """sum_j |x[k+t-1-j] * taps[j]| per output sample (f64)."""
    return np.asarray(jfir.fir_valid_nd(jnp.asarray(np.abs(x), jnp.float64),
                                        jnp.asarray(np.abs(taps), jnp.float64),
                                        "direct"))


@pytest.mark.parametrize("t", TAPS)
def test_fir_f64_matches_direct(t, rng):
    x = rng.standard_normal((3, 900)) * 1e3
    taps = _taps(t)
    want = np.asarray(jfir.fir_valid_nd(jnp.asarray(x), jnp.asarray(taps),
                                        "direct"))
    got = tfir.fir_valid_nd(torch.from_numpy(x), taps).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("t", TAPS)
def test_fir_f32_matches_shift_or_matmul(t, rng):
    x = (rng.standard_normal((3, 900)) * 1e3).astype(np.float32)
    taps = _taps(t).astype(np.float32)
    method = "shift" if t <= 8 else "matmul"
    want = np.asarray(jfir.fir_valid_nd(jnp.asarray(x), jnp.asarray(taps),
                                        method))
    got = tfir.fir_valid_nd(torch.from_numpy(x), taps).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 1e-6 * _scale(x, taps)).all(), err.max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fir_multi_and_per_chain(dtype, rng):
    """The correlator quad (fir_valid_multi) and per-chain taps
    (fir_valid_per_chain, the JAX package's vmap over chains)."""
    x = (rng.standard_normal((2, 700)) * 1e3).astype(dtype)
    quad = np.stack([np.cos(np.arange(8) * k) for k in (0.5, 0.6, 0.7, 0.8)])
    quad = quad.astype(dtype)
    method = "direct" if dtype == np.float64 else "shift"
    want = np.asarray(jfir.fir_valid_multi(jnp.asarray(x), jnp.asarray(quad),
                                           method))
    got = tfir.fir_valid_multi(torch.from_numpy(x), quad).numpy()
    assert got.shape == want.shape == (4, 2, 693)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    scale = np.stack([_scale(x, q) for q in quad])
    assert (np.abs(got - want) <= tol * scale).all()

    per = np.stack([_taps(67), _taps(67) * 0.5]).astype(dtype)
    xs = np.stack([x, x[::-1].copy()])  # (C=2, B=2, n)
    got = tfir.fir_valid_per_chain(torch.from_numpy(xs), per).numpy()
    method = "direct" if dtype == np.float64 else "matmul"
    for c in range(2):
        want = np.asarray(jfir.fir_valid_nd(jnp.asarray(xs[c]),
                                            jnp.asarray(per[c]), method))
        assert (np.abs(got[c] - want) <= tol * _scale(xs[c], per[c])).all()
