"""The lane forms of the float64 twins of kernels K13 and K14 on the CPU,
against the JAX package's f64 scans.

``agc_lanes`` (K13's twin ``agc_follower``) equals
``pymodem_tpu.dsp.agc.agc_apply`` bitwise, lane by lane, each lane with
its own AGC rows and its own whole-row ``normal``.  ``qpsk_costas_lanes``
(K14's twin ``qpsk_costas``; 17 rows with the AGC fused, 12 without)
equals ``agc_apply`` then ``pymodem_tpu.dsp.loops.qpsk_costas``, or the
loop alone, to 1e-12 of the peak (XLA's CPU scan contracts multiply-adds
where the twin rounds each operation), on lanes of their own rows and on
lanes that share rows through ``row_of_lane``, as a pre-shared bank's
chains do.  T runs across the edges of the kernels' 64-sample tiles.  T
stays short: the twins step in Python.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymodem_tpu.dsp import loops as jloops
from pymodem_tpu.dsp.agc import agc_apply
from pymodem_tpu_torch.dsp import agc as tagc
from pymodem_tpu_torch.dsp import loops as tloops
from pymodem_tpu_torch.dsp import window_design as wd

F64 = torch.float64
RATE = 44100.0
# 1 sample, a tile less 1, a tile, a tile and 1, two tiles and 1
T_EDGES = [1, 63, 64, 65, 129]
N_LANES = 7
# the shared-rows case: 7 lanes on 3 rows, unsorted
SHARED_ROWS = np.array([2, 0, 1, 0, 2, 1, 1], np.int32)
# the QPSK-2400 Costas preset's loop and branch IIR rows at 44.1 kHz
# (PLL_PARAMS then BRANCH_PARAMS), each lane's carrier 0.25 Hz apart
QPSK_ROWS = [2 * np.pi / RATE, 1800.0, 256 / (2 * np.pi), 0.014048,
             0.971903, 45.0, 450.0, 2e-4, 87.5, 0.0, 0.078930, 0.842139]


def _rows(n_rows, T, seed):
    """(n_rows, T) float64: a noisy QPSK-2400 carrier at 1800 Hz, int16
    scale, a different phase and noise each row."""
    g = np.random.default_rng(seed)
    t = np.arange(T) / RATE
    k = np.arange(T) * 1200 // int(RATE)
    phase = 2 * np.pi * (1800.0 * t + g.random((n_rows, 1)))
    s_i = (g.integers(0, 2, (n_rows, k[-1] + 1)) * 2 - 1)[:, k]
    s_q = (g.integers(0, 2, (n_rows, k[-1] + 1)) * 2 - 1)[:, k]
    return (2000.0 * (s_i * np.cos(phase) - s_q * np.sin(phase))
            + 300.0 * g.standard_normal((n_rows, T)))


def _agc_rates(L, seed):
    """Per-lane AGC constants (scaled_attack, scaled_decay, sustain_time,
    sustain_increment, target) around the MPSK presets' at 44.1 kHz; a
    sustain of 8-40 samples, so that short rows decay too."""
    g = np.random.default_rng(seed)
    return np.stack([
        500.0 / RATE * (0.5 + g.random(L)),
        50.0 / RATE * (0.5 + g.random(L)),
        g.integers(8, 40, L) / RATE,
        np.full(L, 1.0 / RATE),
        0.5 + g.random(L),
    ])


def _agc_lane_rows(rates, normals):
    """The port's (5, L) AGC rows: the attack and decay steps scaled by
    each lane's signed max, as ``agc_apply`` scales them."""
    rows = rates.copy()
    rows[:2] = rates[:2] * normals
    return rows


@jax.jit
def _jax_agc(x, rates, normals):
    """``agc_apply`` on each lane (x (L, T)) with its own constants."""
    return jax.vmap(lambda xl, r, n: agc_apply(xl, *r, normal=n))(
        x, rates.T, normals)


@jax.jit
def _jax_qpsk(x, rows):
    """``qpsk_costas`` on each lane (x (L, T)) with its own (12,) rows."""
    wavetable = jnp.asarray(wd.nco_wavetable(256, 1.0), jnp.float64)

    def lane(xl, r):
        return jloops.qpsk_costas(xl, jloops.QPSKLoopParams(
            base=jloops.LoopParams(wavetable, r[1], r[0], r[2], r[3], r[4],
                                   r[5], r[6], r[7], r[8], r[9]),
            branch_b0=r[10], branch_a1=r[11]))

    return jax.vmap(lane)(x, rows.T)


def _close(got, want):
    got = got.numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("T", T_EDGES)
@pytest.mark.parametrize("n_lanes", [1, N_LANES])
def test_agc_lanes_f64_equal_jax_agc_apply(n_lanes, T):
    """K13's twin over lanes (through ``agc_lanes`` on the CPU) equals the
    JAX package's f64 ``agc_apply`` lane by lane, bitwise."""
    x = _rows(n_lanes, T, seed=T)
    rates = _agc_rates(n_lanes, seed=T + 1)
    normals = x.max(axis=1)
    got = tagc.agc_lanes(torch.from_numpy(x),
                         torch.from_numpy(_agc_lane_rows(rates, normals)))
    want = np.asarray(_jax_agc(jnp.asarray(x), jnp.asarray(rates),
                               jnp.asarray(normals)))
    assert got.dtype == F64 and got.shape == (n_lanes, T)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("T", T_EDGES)
@pytest.mark.parametrize("rows", ["own", "shared"])
@pytest.mark.parametrize("n_rows", [17, 12], ids=["agc_fused", "loop_only"])
def test_qpsk_costas_lanes_f64_match_jax_scans(n_rows, rows, T):
    """K14's twin over lanes (through ``qpsk_costas_lanes`` on the CPU),
    on 7 lanes of their own rows or on 3 rows shared through
    ``row_of_lane``: both rails within 1e-12 of the peak of the JAX
    package's f64 ``qpsk_costas`` on each lane's row, after its f64
    ``agc_apply`` with 17 rows."""
    row_of_lane = SHARED_ROWS if rows == "shared" else None
    x = _rows(3 if rows == "shared" else N_LANES, T, seed=T + 2)
    lanes = x[row_of_lane] if rows == "shared" else x
    loop = np.array(QPSK_ROWS)[:, None].repeat(N_LANES, 1)
    loop[1] += 0.25 * np.arange(N_LANES)
    leveled = jnp.asarray(lanes)
    lane_rows = loop
    if n_rows == 17:
        rates = _agc_rates(N_LANES, seed=T + 3)
        normals = lanes.max(axis=1)
        leveled = _jax_agc(leveled, jnp.asarray(rates), jnp.asarray(normals))
        lane_rows = np.concatenate([loop, _agc_lane_rows(rates, normals)])
    want = _jax_qpsk(leveled, jnp.asarray(loop))
    tables = (torch.from_numpy(t) for t in
              tloops.f64_nco_tables(wd.nco_wavetable(256, 1.0)))
    got = tloops.qpsk_costas_lanes(
        torch.from_numpy(x), torch.from_numpy(lane_rows), *tables,
        None if row_of_lane is None else torch.from_numpy(row_of_lane))
    for g, w in zip(got, want):
        assert g.shape == (N_LANES, T)
        _close(g, np.asarray(w))
