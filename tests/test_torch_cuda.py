"""The port's CUDA kernels (K1-K16) on the card, against their plain twins.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it also
runs where JAX is not installed (the tests' conftest.py imports JAX, so run
it there with ``python -m pytest --noconftest tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from pymodem_tpu_torch.dsp import agc as tagc
from pymodem_tpu_torch.dsp import loops as tloops
from pymodem_tpu_torch.ops import slicers as tsl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _lanes(seed, n_lanes, n_samples, device):
    g = np.random.default_rng(seed)
    sps = g.choice([6.0, 8.0, 26.666666, 40.0], n_lanes).astype(np.float32)
    lock = g.choice([0.6, 0.75, 0.9], n_lanes).astype(np.float32)
    idx = np.arange(n_samples)[None, :] / sps[:, None]
    sym = g.integers(0, 2, (n_lanes, int(idx.max()) + 2)) * 2.0 - 1.0
    x = np.take_along_axis(sym, idx.astype(np.int64), 1)
    x = (x + 0.4 * g.standard_normal(x.shape)).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(np.stack([sps, lock])).to(device))


# samples a lane: a multiple of 4, and 3 tiles of 128 and 5 (padded rows)
_T_EDGES = [4000, 3 * 128 + 5]
# L: one block in part, not a multiple of 32, a single lane; the 31 lanes'
# rows start 4 bytes past a 16-byte boundary (padded copies), the 64 lanes'
# are a view of wider rows (a FIR's output), taken as they lie
_SLICER_LANES = [(300, "as_they_are"), (31, "offset"), (1, "as_they_are"),
                 (64, "strided")]
_SLICER_LANE_IDS = ["300_lanes", "31_offset_lanes", "1_lane",
                    "64_strided_lanes"]


def _staged(x, rows, T):
    """``x`` as the card tests hand it to a staged slicer (K1, K8): as it
    is, with rows off a 16-byte boundary, or as a view of rows 4 to 7
    floats longer; and whether the kernel takes its rows as they lie (else
    through a padded copy)."""
    from pymodem_tpu_torch import _ext

    if rows == "offset":
        x = _offset_rows(x)
    elif rows == "strided":
        wide = x.new_zeros((x.shape[0], -(-T // 4) * 4 + 4))
        wide[:, :T] = x
        x = wide[:, :T]
    aligned = rows == "strided" or (rows == "as_they_are" and T % 4 == 0)
    assert _ext.rows_aligned(x) == aligned
    return x, aligned


@pytest.mark.parametrize("T", _T_EDGES)
@pytest.mark.parametrize("lanes,rows", _SLICER_LANES, ids=_SLICER_LANE_IDS)
@pytest.mark.parametrize("window", [1, 8, 32, 64, 256])
def test_binary_slicer_kernel_matches_twin(cuda, window, lanes, rows, T):
    """Windows shorter and longer than the 128-sample tile; T a multiple
    of 4, or 3 tiles of 128 and 5 (padded rows, a ragged last tile and
    window); L not a multiple of 32; rows as they are or padded."""
    from pymodem_tpu_torch import _ext

    x, lp = _lanes(0, lanes, T, cuda)
    x, aligned = _staged(x, rows, T)
    before = tsl.binary_slice_lanes.launches
    copies = _ext.lane_rows.copies
    got = tsl.binary_slice_lanes(x, lp, window)
    want = tsl.binary_slice(x, lp, window)
    torch.cuda.synchronize()
    assert tsl.binary_slice_lanes.launches == before + 1
    assert _ext.lane_rows.copies == copies + (not aligned)
    assert got.shape == (lanes, -(-T // window))
    assert torch.equal(got, want)
    assert bool(((got & 0x100) != 0).any())


def _tables(device):
    return (torch.from_numpy(tloops.nco_sine_table()).to(device),
            torch.from_numpy(tloops.nco_cos_table()).to(device))


def _carrier(seed, L, T, device, iq=False):
    """(L, T) f32 noisy +-1 symbols at 1200 Bd on a 1500 Hz carrier at
    44.1 kHz, or the analytic (re, im) pair of it."""
    g = np.random.default_rng(seed)
    t = np.arange(T) / 44100.0
    k = (np.arange(T) * 1200 // 44100)
    w = 2 * np.pi * (1500.0 + g.uniform(-8, 8, (L, 1))) * t
    s_i = (g.integers(0, 2, (L, k[-1] + 1)) * 2 - 1)[:, k]
    s_q = (g.integers(0, 2, (L, k[-1] + 1)) * 2 - 1)[:, k]
    if not iq:
        x = 2.0 * s_i * np.cos(w) + 0.2 * g.standard_normal((L, T))
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)
    re = 0.7 * (s_i * np.cos(w) - s_q * np.sin(w))
    im = 0.7 * (s_i * np.sin(w) + s_q * np.cos(w))
    return tuple(torch.from_numpy(np.ascontiguousarray(
        v + 0.05 * g.standard_normal((L, T)), np.float32)).to(device)
        for v in (re, im))


# loop rows of the BPSK 1200 preset at 44.1 kHz (PLL_PARAMS order), then
# its AGC rows with normal 2
_PLL_ROWS = [2 * np.pi / 44100, 1500.0, 256 / (2 * np.pi), 0.0175, 0.965,
             720.0, 1800.0, 4e-4, 62.5, 0.0]
_AGC_ROWS = [500 / 44100 * 2, 50 / 44100 * 2, 1.0, 1 / 44100, 1.0]


def _rows(values, L, device, vary=None):
    lp = torch.tensor(values, dtype=torch.float32)[:, None].repeat(1, L)
    if vary is not None:
        lp[vary] += torch.linspace(-5, 5, L)
    return lp.to(device).contiguous()


def _offset_rows(x):
    """A contiguous copy of the (n, T) tensor ``x`` whose rows start 4
    bytes past a 16-byte boundary."""
    n, T = x.shape
    return torch.empty(n * T + 1, dtype=x.dtype, device=x.device)[1:] \
        .view(n, T).copy_(x)


def _special(x, seed):
    """``x`` with an all-zero row (0), a row of -0.0 (1), and NaN, -0.0 and
    0.0 sprinkled over rows 2-5."""
    g = np.random.default_rng(seed)
    x = x.clone()
    x[0] = 0.0
    x[1] = -0.0
    part = x[2:6]
    for value, frac in ((float("nan"), 0.02), (-0.0, 0.1), (0.0, 0.1)):
        part[torch.from_numpy(g.random(tuple(part.shape)) < frac)
             .to(x.device)] = value
    return x


def _same_bits(got, want):
    """Equal bit for bit, except that any NaN equals any NaN."""
    nan = torch.tensor(float("nan"), dtype=got.dtype, device=got.device)
    bits = torch.int64 if got.dtype == torch.float64 else torch.int32
    return torch.equal(torch.where(got.isnan(), nan, got).view(bits),
                       torch.where(want.isnan(), nan, want).view(bits))


@pytest.mark.parametrize("T", [4000, 3 * 128 + 5])
@pytest.mark.parametrize("rows", ["as_they_are", "offset", "special"])
def test_agc_kernel_matches_twin(cuda, rows, T):
    """150 lanes (not a multiple of 32); T a multiple of 4, or 3 tiles of
    128 and 5 (padded rows); rows that start off a 16-byte boundary
    (padded); zero, -0.0 and NaN samples, where the envelope stays 0 and
    the output is the input."""
    from pymodem_tpu_torch import _ext

    x = _carrier(3, 150, T, cuda) * torch.linspace(0.1, 3, 150,
                                                   device=cuda)[:, None]
    if rows == "offset":
        x = _offset_rows(x)
    elif rows == "special":
        x = _special(x, 17)
    assert _ext.rows_aligned(x) == (rows != "offset" and T % 4 == 0)
    lp = _rows(_AGC_ROWS, 150, cuda)
    before = tagc.agc_lanes.launches
    got = tagc.agc_lanes(x, lp)
    want = tagc.agc_follower(x, lp)
    torch.cuda.synchronize()
    assert tagc.agc_lanes.launches == before + 1
    assert got.shape == (150, T)
    assert _same_bits(got, want)
    if rows == "special":
        assert _same_bits(got[:2], x[:2])  # the envelope stays 0
    else:
        assert torch.isfinite(got).all()


# K2 and K3: lanes on their own rows, as for K1 and K8, or 8 chains of 37
# lanes on 37 shared rows (``row_of_lane``, a pre-shared bank)
_LOOP_LANES = _SLICER_LANES + [(296, "shared")]
_LOOP_LANE_IDS = _SLICER_LANE_IDS + ["8x37_shared_lanes"]
# the AFSK-PLL "300" loop at 8 kHz (PLL_PARAMS order), then AGC rows
_AFSK_PLL_ROWS = [2 * np.pi / 8000, 1700.0, 256 / (2 * np.pi), 0.0557,
                  0.8886, 540.0, 900.0, 1e-4, 50.0, 0.0, 0.1, 0.01, 1.0,
                  1.25e-4, 1.0]


def _afsk(seed, L, T, device):
    """(L, T) f32 noisy tones near 1700 Hz at 8 kHz, the PLL's input."""
    g = np.random.default_rng(seed)
    t = np.arange(T) / 8000.0
    x = 2.0 * np.sin(2 * np.pi * (1700.0 + g.uniform(-8, 8, (L, 1))) * t)
    return torch.from_numpy((x + 0.3 * g.standard_normal((L, T)))
                            .astype(np.float32)).to(device)


def _loop_inputs(kind, lanes, T, device, seed=1):
    """K2 (``afsk_pll``) or K3 (``bpsk``) inputs for ``lanes`` lanes: rows
    of the input and the 15 lane rows, the carrier varied across lanes."""
    if kind == "afsk_pll":
        return _afsk(seed, lanes, T, device), _rows(_AFSK_PLL_ROWS, lanes,
                                                    device, vary=1)
    return (_carrier(seed, lanes, T, device),
            _rows(_PLL_ROWS + _AGC_ROWS, lanes, device, vary=1))


def _loop_pair(kind, x, lp, row_of_lane=None):
    """The kernel's and the twin's outputs, and the wrapper's launches."""
    sine, cosine = _tables(x.device)
    if kind == "afsk_pll":
        fn = tloops.afsk_pll_lanes
        before = fn.launches
        got = fn(x, lp, sine, row_of_lane)
        want = tloops.afsk_pll(x, lp, sine, row_of_lane)
    else:
        fn = tloops.bpsk_costas_lanes
        before = fn.launches
        got = fn(x, lp, sine, cosine, row_of_lane)
        want = tloops.bpsk_costas(x, lp, sine, cosine, row_of_lane)
    torch.cuda.synchronize()
    return got, want, fn.launches - before


def _check_loop_kernel(kind, lanes, rows, T, device):
    """K2 or K3 against its twin, bitwise: T a multiple of 4, or 3 tiles of
    128 and 5; L not a multiple of 32; rows as they are, padded, strided
    or shared."""
    from pymodem_tpu_torch import _ext

    row_of_lane = None
    if rows == "shared":
        x, lp = _loop_inputs(kind, 37, T, device)
        lp = _loop_inputs(kind, lanes, T, device)[1]
        row_of_lane = torch.arange(37, dtype=torch.int32,
                                   device=device).repeat(lanes // 37)
        aligned = T % 4 == 0
    else:
        x, lp = _loop_inputs(kind, lanes, T, device)
        x, aligned = _staged(x, rows, T)
    copies = _ext.lane_rows.copies
    got, want, launched = _loop_pair(kind, x, lp, row_of_lane)
    assert launched == 1
    assert _ext.lane_rows.copies == copies + (not aligned)
    assert got.shape == (lanes, T)
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize("T", _T_EDGES)
@pytest.mark.parametrize("lanes,rows", _LOOP_LANES, ids=_LOOP_LANE_IDS)
def test_afsk_pll_kernel_matches_twin(cuda, lanes, rows, T):
    _check_loop_kernel("afsk_pll", lanes, rows, T, cuda)


@pytest.mark.parametrize("T", _T_EDGES)
@pytest.mark.parametrize("lanes,rows", _LOOP_LANES, ids=_LOOP_LANE_IDS)
def test_bpsk_costas_kernel_matches_twin(cuda, lanes, rows, T):
    _check_loop_kernel("bpsk", lanes, rows, T, cuda)


@pytest.mark.parametrize("kind", ["afsk_pll", "bpsk"])
def test_coherent_loop_kernels_special_values(cuda, kind):
    """K2 and K3 on an all-zero row (the envelope stays 0, x passes and the
    outputs are 0), a row of -0.0, NaN, -0.0 and 0.0 sprinkled over rows
    2-5, and rows scaled from 1e-40 (subnormal) to 1e30, whose loops run
    away: kernel and twin agree bit for bit, NaN payloads included."""
    L, T = 100, 3 * 128 + 5
    x, lp = _loop_inputs(kind, L, T, cuda, seed=22)
    scale = torch.logspace(-40, 30, L, dtype=torch.float64)
    x = _special(x, 23) * scale.to(torch.float32).to(cuda)[:, None]
    assert bool((x.abs() < 1.2e-38).logical_and(x != 0).any())  # subnormals
    got, want, _ = _loop_pair(kind, x, lp)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[0] == 0).all())
    assert bool(got.isnan().any())


# the MPSK qpsk_2400 loop at 44.1 kHz (PLL_PARAMS order), pd_gain,
# pd_granularity
_MPSK_ROWS = [2 * np.pi / 44100, 1500.0, 256 / (2 * np.pi), 0.0175, 0.965,
              14400 / 65536 * 0.3, 14400 / 65536, 0.3 / 2000, 31.25, -31.25,
              32.0, 64.0]
def _mpsk_inputs(L, T, n_gains, shared, device, seed=5):
    """K6 inputs for L lanes (not a multiple of 32) of ``n_gains`` detector
    tables: (re, im) rows, lane rows, tables, table index, row_of_lane.
    ``shared``: 8 chains on the same L/8 rows (a pre-shared bank); else one
    row a lane, the identity map."""
    B = L // 8 if shared else L
    re, im = _carrier(seed, B, T, device, iq=True)
    if shared:
        row_of_lane = torch.arange(B, device=device).repeat(8)
    else:
        row_of_lane = torch.arange(L, device=device)
    lp = _rows(_MPSK_ROWS, L, device, vary=1)
    gains = 8.0 + 2.0 * np.arange(n_gains)
    tables = torch.from_numpy(np.stack([
        tloops.pd_error_table(64, k) for k in gains])).to(device)
    index = (torch.arange(L, device=device) % n_gains).to(torch.int32)
    return re, im, lp, tables, index, row_of_lane.to(torch.int32)


@pytest.mark.parametrize("T", _T_EDGES)
@pytest.mark.parametrize("rows", ["identity", "shared"])
@pytest.mark.parametrize("n_gains", [1, 2, 24],
                         ids=["1_gain", "2_gains", "24_gains"])
def test_mpsk_loop_kernel_matches_twin(cuda, n_gains, rows, T):
    """Lanes of one or several detector gains, each reading its own table
    (24 tables of 16 KB are more than a block's shared memory holds, so
    they stay in device memory), on their own rows or on rows shared by 8
    chains."""
    L = 200
    re, im, lp, tables, index, row_of_lane = _mpsk_inputs(
        L, T, n_gains, rows == "shared", cuda)
    sine, cosine = _tables(cuda)
    before = tloops.mpsk_loop_lanes.launches
    got = tloops.mpsk_loop_lanes(re, im, lp, sine, cosine, tables, index,
                                 row_of_lane)
    want = tloops.mpsk_loop(re, im, lp, sine, cosine, tables, index,
                            row_of_lane)
    torch.cuda.synchronize()
    assert tloops.mpsk_loop_lanes.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == (L, T)
        assert torch.isfinite(g).all() and torch.equal(g, w)


def _quad_demap(bps):
    if bps == 2:
        return (3, 1, 2, 0, 2, 3, 0, 1, 1, 0, 3, 2, 0, 2, 1, 3), 0xF
    return (0, 0, 1, 1), 0x3


@pytest.mark.parametrize("T", [3000, 3 * 128 + 5])
@pytest.mark.parametrize("window", [1, 8, 32, 256])
@pytest.mark.parametrize("bps", [1, 2])
def test_quadrature_slicer_kernel_matches_twin(cuda, bps, window, T):
    """300 lanes (not a multiple of 32); T a multiple of 4, or 3 tiles of
    128 and 5 (rows padded to a multiple of 4, a ragged last tile and
    window); windows shorter and longer than a tile."""
    i_l, lp = _lanes(6, 300, T, cuda)
    q_l, _ = _lanes(7, 300, T, cuda)
    demap, mask = _quad_demap(bps)
    before = tsl.quadrature_slice_lanes.launches
    got = tsl.quadrature_slice_lanes(i_l, q_l, lp, demap, mask, bps, window)
    want = tsl.quadrature_slice(i_l, q_l, lp, demap, mask, bps, window)
    torch.cuda.synchronize()
    assert tsl.quadrature_slice_lanes.launches == before + 1
    assert torch.equal(got, want)
    assert bool(((got & 0x100) != 0).any())


def test_lane_kernels_take_unaligned_rows(cuda):
    """K6 and K7 take rows that do not start 16-byte aligned (T a multiple
    of 4) through padded copies, and give the twins' results."""
    from pymodem_tpu_torch import _ext

    re, im, lp, tables, index, row_of_lane = _mpsk_inputs(
        200, 1000, 1, True, cuda, seed=11)
    re, im = _offset_rows(re), _offset_rows(im)
    assert not _ext.rows_aligned(re)
    sine, cosine = _tables(cuda)
    got = tloops.mpsk_loop_lanes(re, im, lp, sine, cosine, tables, index,
                                 row_of_lane)
    want = tloops.mpsk_loop(re, im, lp, sine, cosine, tables, index,
                            row_of_lane)
    i_l, lp = _lanes(12, 200, 1000, cuda)
    q_l, _ = _lanes(13, 200, 1000, cuda)
    i_l, q_l = _offset_rows(i_l), _offset_rows(q_l)
    demap, mask = _quad_demap(2)
    got_q = tsl.quadrature_slice_lanes(i_l, q_l, lp, demap, mask, 2, 32)
    want_q = tsl.quadrature_slice(i_l, q_l, lp, demap, mask, 2, 32)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got_q, want_q)


def _wider(x, extra):
    """A view of ``x``'s samples in rows ``extra`` elements longer."""
    wide = x.new_zeros((x.shape[0], x.shape[1] + extra))
    wide[:, :x.shape[1]] = x
    return wide[:, :x.shape[1]]


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_two_rail_kernels_take_rails_at_two_strides(cuda, kernel):
    """K6 and K7 read both rails at one row stride: a first rail of
    contiguous rows of 4096 floats and a second that is a view of rows of
    4100 (both 16-byte aligned, at two strides) go to the kernel at the
    first rail's stride (one padded copy of the second), and the results
    equal the twins' bitwise."""
    from pymodem_tpu_torch import _ext

    T = 4096
    copies = _ext.lane_rows.copies
    if kernel == "K6":
        re, im, lp, tables, index, row_of_lane = _mpsk_inputs(
            200, T, 1, True, cuda, seed=17)
        rails = (re, _wider(im, 4))
        sine, cosine = _tables(cuda)
        args = (lp, sine, cosine, tables, index, row_of_lane)
        got = tloops.mpsk_loop_lanes(*rails, *args)
        want = tloops.mpsk_loop(*rails, *args)
    else:
        i_l, lp = _lanes(18, 200, T, cuda)
        q_l, _ = _lanes(19, 200, T, cuda)
        rails = (i_l, _wider(q_l, 4))
        demap, mask = _quad_demap(2)
        got = (tsl.quadrature_slice_lanes(*rails, lp, demap, mask, 2, 32),)
        want = (tsl.quadrature_slice(*rails, lp, demap, mask, 2, 32),)
    torch.cuda.synchronize()
    assert all(_ext.rows_aligned(r) for r in rails)
    assert rails[0].stride(0) != rails[1].stride(0)
    assert _ext.lane_rows.copies == copies + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_quadrature_slicer_kernel_nan_and_signed_zero(cuda):
    """NaN samples cross nothing and decide 0 on their rail; -0.0 is >= 0
    (a sign bit would say otherwise); kernel and twin agree."""
    i_l, lp = _lanes(14, 100, 2000, cuda)
    q_l, _ = _lanes(15, 100, 2000, cuda)
    g = np.random.default_rng(16)
    for x in (i_l, q_l):
        for value, frac in ((float("nan"), 0.05), (-0.0, 0.1), (0.0, 0.1)):
            x[torch.from_numpy(g.random(tuple(x.shape)) < frac).to(cuda)] = \
                value
    demap, mask = _quad_demap(2)
    for window in (1, 32):
        got = tsl.quadrature_slice_lanes(i_l, q_l, lp, demap, mask, 2,
                                         window)
        want = tsl.quadrature_slice(i_l, q_l, lp, demap, mask, 2, window)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _four_level(seed, n_lanes, n_samples, device):
    """(L, T) f32 4FSK lanes of ``synth.modulate.four_level_modulate`` at
    48 kHz and 4800 Bd: a preamble of 20 +-3 symbols, whose signs make the
    sync patterns, then random dibits; each lane from its own start, with
    its own gain and noise.  Rows (sps, lock_rate) near its 10 samples a
    symbol."""
    from pymodem_tpu_torch.synth.modulate import four_level_modulate

    g = np.random.default_rng(seed)
    x = np.empty((n_lanes, n_samples), np.float32)
    for lane in range(n_lanes):
        start = int(g.integers(0, 10))
        dibits = g.integers(0, 4, n_samples // 10 + 2).tolist()
        wave = four_level_modulate(dibits, 48000.0, 4800.0,
                                   preamble_symbols=20)
        x[lane] = (wave[start:start + n_samples] * 1e-4
                   * g.uniform(0.2, 2.0)
                   + 0.05 * g.standard_normal(n_samples))
    sps = g.choice([9.9, 10.0, 10.1], n_lanes).astype(np.float32)
    lock = g.choice([0.985, 0.9], n_lanes).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(np.stack([sps, lock])).to(device))


_FL_DEMAP = (2, 0, 3, 1)  # the four-level slicer's (slicer.py:297-308)


def _four_level_twin(x, lp, window):
    """K8's twin on the CPU, where the tests hold it against the JAX scan
    (``test_four_level_twin_on_the_card_matches_cpu`` holds the twin on
    the card equal to it)."""
    return tsl.four_level_slice(x.cpu(), lp.cpu(), _FL_DEMAP, window).to(
        x.device)


def _threshold_dibits(enc):
    """(L,) whether a lane emitted a byte holding dibit 0 or 3: under
    ``_FL_DEMAP`` the decisions 1 and 2 that only a threshold above 0 gives,
    and the threshold leaves 0 only on a sync pattern."""
    byte = (enc & 0xFF).long()
    dibits = torch.stack([(byte >> s) & 3 for s in (0, 2, 4, 6)], -1)
    mid = ((dibits == 0) | (dibits == 3)).any(-1)
    return ((enc & 0x100) != 0).logical_and(mid).any(-1)


@pytest.mark.parametrize("T", _T_EDGES)
@pytest.mark.parametrize("lanes,rows", _SLICER_LANES, ids=_SLICER_LANE_IDS)
@pytest.mark.parametrize("window", [1, 8, 16, 32, 256])
def test_four_level_slicer_kernel_matches_twin(cuda, window, lanes, rows, T):
    """Modulated 4FSK whose preamble hits the sync patterns (asserted: at
    least 90% of the lanes decode symbols that only a threshold set on a
    sync hit gives);
    windows shorter and longer than the tile; T a multiple of 4, or 3 tiles
    of 128 and 5; L not a multiple of 32; rows as they are or padded."""
    from pymodem_tpu_torch import _ext

    x, lp = _four_level(8, lanes, T, cuda)
    x, aligned = _staged(x, rows, T)
    before = tsl.four_level_slice_lanes.launches
    copies = _ext.lane_rows.copies
    got = tsl.four_level_slice_lanes(x, lp, _FL_DEMAP, window)
    want = _four_level_twin(x, lp, window)
    torch.cuda.synchronize()
    assert tsl.four_level_slice_lanes.launches == before + 1
    assert _ext.lane_rows.copies == copies + (not aligned)
    assert got.shape == (lanes, -(-T // window))
    assert torch.equal(got, want)
    assert float(_threshold_dibits(got).float().mean()) >= 0.9


@pytest.mark.parametrize("window", [1, 16])
def test_four_level_twin_on_the_card_matches_cpu(cuda, window):
    """The twin on the card forms ``|x| * 2 / 3`` as the CPU twin does (a
    division by a 0-d tensor on its device; torch on CUDA turns a division
    by a CPU scalar into a multiply by the reciprocal, which rounds about
    a third of the samples otherwise): equal outputs, bitwise, on 4FSK
    lanes that hit the sync patterns, and equal ring values."""
    x, lp = _four_level(24, 200, 3000, cuda)
    got = tsl.four_level_slice(x, lp, _FL_DEMAP, window)
    want = _four_level_twin(x, lp, window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(_threshold_dibits(got).float().mean()) >= 0.9
    three = torch.tensor(3.0, device=cuda)
    assert torch.equal((x.abs() * 2.0 / three).cpu(),
                       x.cpu().abs() * 2.0 / 3.0)


@pytest.mark.parametrize("window", [1, 32])
@pytest.mark.parametrize("kernel", ["binary", "four_level"])
def test_slicer_kernels_special_values(cuda, kernel, window):
    """K1 and K8 on an all-zero row, a row of -0.0, NaN, -0.0 and 0.0
    sprinkled over rows 2-5, and rows scaled from 1e-40 (subnormal) to
    1e30: NaN crosses nothing and is not > 0, -0.0 is >= 0; kernel and
    twin agree."""
    L, T = 100, 1000
    if kernel == "binary":
        x, lp = _lanes(19, L, T, cuda)
    else:
        x, lp = _four_level(20, L, T, cuda)
    scale = torch.logspace(-40, 30, L, dtype=torch.float64)
    x = _special(x, 21) * scale.to(torch.float32).to(cuda)[:, None]
    assert bool((x.abs() < 1.2e-38).logical_and(x != 0).any())  # subnormals
    if kernel == "binary":
        got = tsl.binary_slice_lanes(x, lp, window)
        want = tsl.binary_slice(x, lp, window)
    else:
        got = tsl.four_level_slice_lanes(x, lp, _FL_DEMAP, window)
        want = _four_level_twin(x, lp, window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(((got & 0x100) != 0).any())


# the Costas "2400" preset's loop at 44.1 kHz (PLL_PARAMS order), its branch
# IIR (b0, a1), then AGC rows with normal 2
_QPSK_ROWS = [2 * np.pi / 44100, 1800.0, 256 / (2 * np.pi), 0.014048,
              0.971903, 45.0, 450.0, 2e-4, 87.5, 0.0, 0.078930, 0.842139]


@pytest.mark.parametrize("T", _T_EDGES)
@pytest.mark.parametrize("chains", [0, 1, 2, 8],
                         ids=["identity", "shared_1", "shared_2",
                              "shared_8"])
@pytest.mark.parametrize("n_rows", [17, 12], ids=["agc_fused", "loop_only"])
def test_qpsk_costas_kernel_matches_twin(cuda, n_rows, chains, T):
    """Both row forms; 200 lanes on their own rows, or C chains of 37 lanes
    on 37 shared rows (``row_of_lane``, a pre-shared bank); T a multiple of
    4, or 3 tiles of 128 and 5 (padded rows)."""
    n_in = 200 if chains == 0 else 37
    L = 200 if chains == 0 else 37 * chains
    re, _ = _carrier(9, n_in, T, cuda, iq=True)
    x = (re * 3.0).contiguous()
    row_of_lane = None if chains == 0 else torch.arange(
        n_in, dtype=torch.int32, device=cuda).repeat(chains)
    lp = _rows((_QPSK_ROWS + _AGC_ROWS)[:n_rows], L, cuda, vary=1)
    sine, cosine = _tables(cuda)
    before = tloops.qpsk_costas_lanes.launches
    got = tloops.qpsk_costas_lanes(x, lp, sine, cosine, row_of_lane)
    want = tloops.qpsk_costas(x, lp, sine, cosine, row_of_lane)
    torch.cuda.synchronize()
    assert tloops.qpsk_costas_lanes.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == (L, T)
        assert torch.isfinite(g).all() and torch.equal(g, w)


@pytest.mark.parametrize("n_rows", [17, 12], ids=["agc_fused", "loop_only"])
def test_qpsk_costas_kernel_special_rows(cuda, n_rows):
    """Zero, -0.0 and NaN samples, and rows that start off a 16-byte
    boundary (padded copies): kernel and twin agree bit for bit."""
    re, _ = _carrier(10, 100, 1000, cuda, iq=True)
    x = _offset_rows(_special(re * 3.0, 18))
    lp = _rows((_QPSK_ROWS + _AGC_ROWS)[:n_rows], 100, cuda, vary=1)
    sine, cosine = _tables(cuda)
    got = tloops.qpsk_costas_lanes(x, lp, sine, cosine)
    want = tloops.qpsk_costas(x, lp, sine, cosine)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w)
        assert torch.isfinite(g[6:]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, lp = _lanes(2, 8, 100, cuda)
    # float64 lanes go to K10 and K12, which take float64 rows only
    with pytest.raises(ValueError, match="float32"):
        tsl.binary_slice_lanes(x, lp.double())
    with pytest.raises(ValueError, match="float64"):
        tsl.binary_slice_lanes(x.double(), lp)
    with pytest.raises(ValueError, match="contiguous"):
        tsl.binary_slice_lanes(x.t().contiguous().t(), lp)
    with pytest.raises(ValueError, match="window"):
        tsl.binary_slice_lanes(x, lp, window=3)
    # a float32 first rail is K7's: a float64 second rail or rows raise
    with pytest.raises(ValueError, match="float32"):
        tsl.quadrature_slice_lanes(x, x.double(), lp, (0, 0, 1, 1), 3, 1)
    with pytest.raises(ValueError, match="float32"):
        tsl.quadrature_slice_lanes(x, x, lp.double(), (0, 0, 1, 1), 3, 1)
    with pytest.raises(ValueError, match="float32"):
        tagc.agc_lanes(x, _rows(_AGC_ROWS, 8, cuda).double())
    with pytest.raises(ValueError, match="demap"):
        tsl.quadrature_slice_lanes(x, x, lp, (0, 0, 1, 1), 0xF, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tagc.agc_lanes(x.t().contiguous().t(), _rows(_AGC_ROWS, 8, cuda))
    sine, cosine = _tables(cuda)
    rows15 = _rows(_PLL_ROWS + _AGC_ROWS, 8, cuda)
    with pytest.raises(ValueError, match="NCO tables"):
        tloops.bpsk_costas_lanes(x, rows15, sine, cosine[:128])
    with pytest.raises(ValueError, match="float32"):
        tloops.bpsk_costas_lanes(x, rows15, sine.double(), cosine)
    rows12 = _rows(_PLL_ROWS + [32.0, 64.0], 8, cuda)
    tables = torch.zeros(3, 64 * 64, dtype=torch.int32, device=cuda)
    index = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="g\\*g"):  # not a square table
        tloops.mpsk_loop_lanes(x, x, rows12, sine, cosine,
                               tables[:, 1:].contiguous(), index)
    with pytest.raises(ValueError, match="int32"):
        tloops.mpsk_loop_lanes(x, x, rows12, sine, cosine, tables[:1],
                               index.long())
    with pytest.raises(ValueError, match="float32"):
        tloops.mpsk_loop_lanes(x, x.double(), rows12, sine, cosine,
                               tables[:1], index)
    with pytest.raises(ValueError, match="demap"):
        tsl.four_level_slice_lanes(x, lp, (2, 0, 3))
    with pytest.raises(ValueError, match="window"):
        tsl.four_level_slice_lanes(x, lp, (2, 0, 3, 1), window=512)
    with pytest.raises(ValueError, match="float32"):
        tsl.four_level_slice_lanes(x, lp.double(), (2, 0, 3, 1))
    with pytest.raises(ValueError, match="float64"):
        tsl.four_level_slice_lanes(x.double(), lp, (2, 0, 3, 1))
    with pytest.raises(ValueError, match="17"):
        tloops.qpsk_costas_lanes(x, rows15, sine, cosine)
    rows17 = _rows(_QPSK_ROWS + _AGC_ROWS, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tloops.qpsk_costas_lanes(x.t().contiguous().t(), rows17, sine,
                                 cosine)
    with pytest.raises(ValueError, match="NCO tables"):
        tloops.qpsk_costas_lanes(x, rows17, sine[:128], cosine)
    with pytest.raises(ValueError, match="float32"):
        tloops.qpsk_costas_lanes(x, rows17.double(), sine, cosine)
    from pymodem_tpu_torch.codecs import ax25_device as tax

    rows = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    counts = torch.full((4,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        tax.ax25_deframe_rows(rows.int(), counts, 8, 18, 1023)
    with pytest.raises(ValueError, match="int32"):
        tax.ax25_deframe_rows(rows, counts.long(), 8, 18, 1023)
    with pytest.raises(ValueError, match="contiguous"):
        tax.ax25_deframe_rows(rows.t().contiguous().t(), counts, 8, 18, 1023)


# ---------------------------------------------------------------------------
# The device IL2P codec: CUDA against the same calls on the CPU (the CPU
# tests hold the CPU side against the JAX package)
# ---------------------------------------------------------------------------


def _rs_rows(seed, num_roots, B, L):
    """B codewords of random block sizes with 0 to 9 byte errors each."""
    from pymodem_tpu_torch.ops import rs as trs

    g = np.random.default_rng(seed)
    code = trs.make_rs(0, num_roots)
    data = g.integers(0, 256, (B, L)).astype(np.int32)
    bs = np.zeros(B, np.int32)
    for i in range(B):
        n = 15 if num_roots == 2 else int(g.integers(17, 256))
        cw = trs.rs_encode_np(code, g.integers(0, 256, n - num_roots))
        pos = g.choice(n, min(int(g.integers(0, 10)), n), replace=False)
        cw[pos] ^= g.integers(1, 256, len(pos))
        data[i, :n], bs[i] = cw, n
    return torch.from_numpy(data), torch.from_numpy(bs)


@pytest.mark.parametrize(
    "num_roots,B,L,min_distance,fail_budget",
    [(16, 300, 255, 0, None), (2, 300, 15, 1, 64), (16, 2500, 255, 0, 512)],
    ids=["16roots", "2roots_md1_split", "16roots_2500rows_split"])
def test_rs_decode_on_the_card_matches_cpu(cuda, num_roots, B, L,
                                          min_distance, fail_budget):
    from pymodem_tpu_torch.ops import rs as trs

    data, bs = _rs_rows(7, num_roots, B, L)
    want = trs.rs_decode(data, bs, num_roots, min_distance=min_distance,
                         fail_budget=fail_budget)
    got = trs.rs_decode(data.to(cuda), bs.to(cuda), num_roots,
                        min_distance=min_distance, fail_budget=fail_budget)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    if fail_budget is not None:
        assert want[2].any()  # the budget overflowed


def test_crc16_masked_on_the_card_matches_cpu(cuda):
    from pymodem_tpu_torch.ops.crc import crc16_masked, np_crc16

    g = np.random.default_rng(8)
    data = torch.from_numpy(g.integers(0, 256, (3000, 535), dtype=np.uint8))
    length = torch.from_numpy(g.integers(0, 540, 3000))
    length[:3] = torch.tensor([0, 1, 535])
    want = crc16_masked(data, length)
    got = crc16_masked(data.to(cuda), length.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert int(want[2]) == np_crc16(data[2].numpy())


def _codec_blocks(seed=9, K=1280):
    """IL2P byte-stream blocks for il2p_decode_blocks: clean frames,
    RS-corrected frames, noise, embedded syncs and 2-5 block payloads;
    (data, sync, counts, addresses) on the CPU."""
    from pymodem_tpu_torch.ops.sync import il2p_sync_candidates, pack_bits
    from pymodem_tpu_torch.synth import encode as enc
    from pymodem_tpu_torch.synth.fixtures import payloads

    g = np.random.default_rng(seed)

    def frames(n, corrupt=0, size=30):
        parts = []
        for i in range(n):
            parts.append(g.integers(0, 256, 40))
            payload = payloads(g, count=1, size=size + 60 * i)[0]
            frame = np.array(enc.il2p_frame("KI5ABC", "N0CALL", payload),
                             dtype=np.int64)
            if corrupt:
                pos = g.choice(np.arange(20, len(frame) - 6), corrupt,
                               replace=False)
                frame[pos] ^= g.integers(1, 256, corrupt)
            parts.append(frame)
        return np.concatenate(parts + [g.integers(0, 256, 40)])

    syncs = np.concatenate([np.concatenate([
        g.integers(0, 256, 20), [0xF1, 0x5E, 0x48], g.integers(0, 256, 90)])
        for _ in range(10)])
    streams = [frames(3), frames(3, corrupt=4), g.integers(0, 256, K), syncs,
               frames(1, size=300), frames(1, corrupt=3, size=500),
               frames(1, size=1023)]
    data = np.zeros((len(streams), K), np.uint8)
    counts = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        data[i, : len(s)], counts[i] = s, len(s)
    data = torch.from_numpy(data)
    sync = pack_bits(il2p_sync_candidates(data))
    addr = (torch.arange(1, K + 1, dtype=torch.int32)[None, :]
            + 5000 * torch.arange(len(streams), dtype=torch.int32)[:, None])
    return data, sync, torch.from_numpy(counts), addr.contiguous()


@pytest.mark.parametrize("kw,overflows", [
    ({}, False), ({"collect_crc": False, "scan_cap": 16}, False),
    ({"total_candidates": 600, "scan_cap": 16}, False),
    ({"total_candidates": 8, "scan_cap": 16}, True), ({"scan_cap": 8}, True),
    ({"max_packets": 2, "scan_cap": 16}, True),
    ({"max_payload": 128, "scan_cap": 16}, True),
], ids=["default", "no_crc", "syndrome_split", "candidates_overflow",
        "scan_overflow", "packets_overflow", "payload_overflow"])
def test_il2p_decode_blocks_on_the_card_matches_cpu(cuda, kw, overflows):
    from pymodem_tpu_torch.codecs.il2p_device import il2p_decode_blocks

    arrays = _codec_blocks()
    want = il2p_decode_blocks(*arrays, **kw)
    got = il2p_decode_blocks(*(a.to(cuda) for a in arrays), **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].device.type == "cuda"
        assert torch.equal(got[key].cpu(), want[key]), key
    assert want["ok"].sum() > 0
    assert bool(want["dropped"].any()) == overflows


def _ax25_rows(n_rows, seed):
    """(n_rows, K) uint8 rows, int32 counts: HDLC frames among noise, runs
    of ones (stuffing and aborts), a frame over 1023 bytes, and counts past
    K, zero and short."""
    from pymodem_tpu_torch.synth import encode as enc

    g = np.random.default_rng(seed)
    bits = []
    for i in range(6):
        bits += [1] * int(g.integers(1, 12)) + [0] * int(g.integers(1, 3))
        bits += [int(b) for b in g.integers(0, 2, 120)]
        size = 1100 if i == 3 else int(g.integers(16, 60))
        payload = bytes(g.integers(32, 127, size).astype(np.uint8))
        bits += enc.hdlc_encode(enc.ax25_ui_frame("KI5ABC", "N0CALL",
                                                  payload), flag_count=2)
    bits += [0] * ((8 - len(bits) % 8) % 8)
    stream = np.array(enc.bits_to_bytes_msb(bits), np.uint8)
    K = len(stream) + 37
    data = g.integers(0, 256, (n_rows, K)).astype(np.uint8)
    counts = g.integers(0, K + 60, n_rows).astype(np.int32)
    for r in range(0, n_rows, 3):
        shift = int(g.integers(0, K - len(stream)))
        data[r, shift:shift + len(stream)] = stream
        counts[r] = shift + len(stream)
    counts[1:2] = 0
    return torch.from_numpy(data), torch.from_numpy(counts)


def _ax25_edge_case(case, seed):
    """K9's edge rows (``synth/fixtures.ax25_edge_rows``) at an odd K: 1571
    bytes, one tile of the block (``edges``, and each count among full,
    0, short and past K), or 4099, past a tile (``two_tiles``); or one row
    alone (``one_edge_row``: a run of ones across a warp's span)."""
    from pymodem_tpu_torch.synth.fixtures import ax25_edge_rows

    g = np.random.default_rng(seed)
    K = 4099 if case == "two_tiles" else 1571
    data, names = ax25_edge_rows(K, g)
    if case == "one_edge_row":
        data = data[names.index("ones9_across_bit4096")][None]
    counts = np.full(len(data), K, np.int32)
    if case == "edges":
        counts[::4] = g.integers(-3, K, len(counts[::4]))
        counts[1::4] = 0
        counts[2::4] = K + 7
    return torch.from_numpy(data), torch.from_numpy(counts)


@pytest.mark.parametrize("n_rows,max_packets",
                         [(1, 8), (45, 8), (300, 2), ("edges", 8),
                          ("edges", 2), ("two_tiles", 8),
                          ("one_edge_row", 8)])
def test_ax25_deframe_kernel_matches_twin(cuda, n_rows, max_packets):
    """K9 against its plain twin on the card, every output bitwise, and
    ax25_decode_blocks on the card against the CPU; also on the edge rows
    at odd K (runs of ones across words, threads' and warps' spans and
    tiles, all ones, closing flags at every bit of a word, more closing
    flags than packet slots, counts of 0 and past K) and on one row."""
    from pymodem_tpu_torch.codecs import ax25_device as tax

    if isinstance(n_rows, str):
        data, counts = _ax25_edge_case(n_rows, 29)
    else:
        data, counts = _ax25_rows(n_rows, 13 + n_rows)
    d, c = data.to(cuda), counts.to(cuda)
    before = tax.ax25_deframe_rows.launches
    got = tax.ax25_deframe_rows(d, c, max_packets, 18, 1023)
    assert tax.ax25_deframe_rows.launches == before + 1
    want = tax.ax25_deframe(d, c, max_packets, 18, 1023)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    addr = torch.arange(data.numel(), dtype=torch.int32).reshape(data.shape)
    on_card = tax.ax25_decode_blocks(d, c, addr.to(cuda),
                                     max_packets=max_packets)
    on_cpu = tax.ax25_decode_blocks(data, counts, addr,
                                    max_packets=max_packets)
    for key, value in on_cpu.items():
        assert torch.equal(on_card[key].cpu(), value), key
    if max_packets == 2 or n_rows == "two_tiles":
        assert int(on_cpu["dropped"].max()) > 0
    if isinstance(n_rows, str):
        assert int(on_cpu["crc_ok"].sum()) > 0


def _pll_stream_case():
    """An AFSK-PLL chain at 8 kHz and 11.6 s of int16 audio carrying 4
    IL2P+CRC frames (1600/1800 Hz, 8-byte payloads)."""
    from pymodem_tpu_torch.config import build_chain_spec
    from pymodem_tpu_torch.synth import fixtures as fx
    from pymodem_tpu_torch.synth import modulate as mod

    line = {
        "object_name": "AFSK 300 Il2Pc PLL", "object_type": "demod_chain",
        "modem": {"type": "afsk_pll", "config": "300", "options": {}},
        "slicer": {"type": "binary", "config": "300", "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                               "invert": "no"}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }
    sent = fx.payloads(np.random.default_rng(20261017), count=4, size=8)
    bits = fx.il2p_line_bits(sent, polynomial=0x3, invert=False,
                             gap_bits=400)
    audio = mod.to_int16(mod.afsk_modulate(bits, 8000.0, 300.0, 1600.0,
                                           1800.0))
    return [build_chain_spec(8000.0, line)], sent, audio


def test_stream_on_the_card_matches_cpu(cuda):
    """A PLL-bank stream on the card (K1, K2 and the device codec) gives
    the CPU stream's packets, and its tail stays on the card."""
    from pymodem_tpu_torch.dsp.loops import afsk_pll_lanes
    from pymodem_tpu_torch.runtime.stream import StreamDecoder

    chains, sent, audio = _pll_stream_case()
    got = {}
    for dev in ("cpu", "cuda"):
        dec = StreamDecoder(chains, 8000, block_seconds=1.5,
                            overlap_seconds=2.5, blocks_per_step=4,
                            device=dev)
        before = afsk_pll_lanes.launches
        out = []
        for i in range(0, len(audio), 7001):
            out += dec.feed(audio[i:i + 7001])
        out += dec.drain()
        (st,) = dec._banks
        assert st.tail.device.type == dev
        assert st.tail.shape == (st.plan.block_input_len - dec.block_len,)
        assert st.tail_block == st.next_block > 0
        out += dec.flush()
        if dev == "cuda":
            assert afsk_pll_lanes.launches > before
        got[dev] = [(list(p.data), p.streamaddress, p.bytes_corrected)
                    for p in out]
    assert got["cuda"] == got["cpu"]
    assert [bytes(d[16:-2]) for d, _, _ in got["cuda"]] == sent


_TRIP_CHILD = """
import sys
import torch
from pymodem_tpu_torch import cli
from pymodem_tpu_torch.runtime import bank

real = bank.dispatch_bank


def tripped(bank_, plan, audio, tol):
    # a device-side assert: the CUDA context is dead from here on
    torch._assert_async(torch.zeros((), dtype=torch.bool,
                                    device=audio.device))
    return real(bank_, plan, audio, tol)


bank.dispatch_bank = tripped
sys.exit(cli.main(["pymodem_tpu_torch", sys.argv[1], sys.argv[2]]))
"""


def test_cli_after_a_device_side_fault(cuda, tmp_path):
    """The CLI in a child process whose bank dispatch trips a device-side
    assert: the context is dead, so the resilient retry cannot run.  The
    process names the error once and exits non-zero (1), without
    hanging, retrying chain by chain or printing a report."""
    import json
    import os
    import subprocess
    import sys

    from pymodem_tpu_torch.wav_io import write_wav

    chains, _sent, audio = _pll_stream_case()
    cfg = tmp_path / "pll.json"
    line = {
        "object_name": "AFSK 300 Il2Pc PLL", "object_type": "demod_chain",
        "modem": {"type": "afsk_pll", "config": "300", "options": {}},
        "slicer": {"type": "binary", "config": "300", "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                               "invert": "no"}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }
    cfg.write_text(json.dumps(line) + "\n" + json.dumps(
        {"object_name": "report", "object_type": "report",
         "options": {"style": "decoded_headers"}}) + "\n")
    wav = tmp_path / "pll.wav"
    write_wav(str(wav), 8000, audio)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _TRIP_CHILD, str(cfg), str(wav)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=300)
    out = proc.stdout
    assert proc.returncode == 1, (proc.returncode, out, proc.stderr[-2000:])
    assert out.count("banked runtime failed") == 1, out
    assert "the device is lost, no retry" in out
    assert "skipped chain" not in out and "Generating" not in out


# ---------------------------------------------------------------------------
# the float64 parity mode's kernels K10-K16
# ---------------------------------------------------------------------------


def _f64_rows(lanes, rows, T, device):
    """(x, lane_params): float64 slicer lanes (``_lanes``' symbols), as
    they are, as a view of rows 5 doubles longer (a FIR's output), or
    (``special``) with negative subnormals, which a float32 cast would
    round to -0.0, and NaNs sprinkled over them."""
    x, lp = _lanes(11, lanes, T, device)
    x, lp = x.double(), lp.double()
    if rows == "strided":
        wide = x.new_zeros((lanes, T + 5))
        wide[:, :T] = x
        x = wide[:, :T]
    elif rows == "special":
        x[:, 3::17] = -4.9e-324
        x[:, 8::23] = -2.5e-310
        x[:, 5::29] = float("nan")
        x[:, 11::31] = 2.5e-310
    return x, lp


# T at the edges of the staged f64 kernels' tiles (64 samples for K11, 128
# for K10): 1 sample, a tile less 1, a tile, two tiles and 1
_K11_T_EDGES = [1, 63, 64, 129]
_K10_T_EDGES = [1, 127, 128, 257]


@pytest.mark.parametrize("T", [4000, 3 * 128 + 5, *_K10_T_EDGES])
@pytest.mark.parametrize("lanes,rows", [(300, "as_they_are"), (1, "as_they_are"),
                                        (45, "strided"), (70, "special")])
@pytest.mark.parametrize("window", [1, 8, 256])
def test_binary_slicer_f64_kernel_matches_twin(cuda, window, lanes, rows, T):
    """K10 equals the f64 twin bitwise; binary_slice_lanes routes float64
    to it, never to K1.  Rows at an odd stride (T + 5 doubles, T even) or
    of odd T go through a padded copy, the others as they lie; negative
    subnormals decide 0 and cross as negatives, NaNs cross nothing."""
    from pymodem_tpu_torch import _ext

    x, lp = _f64_rows(lanes, rows, T, cuda)
    if rows == "special":
        assert bool(x.isnan().any()) or T < 6
    k1 = tsl.binary_slice_lanes.launches
    k10 = tsl.binary_slice_f64_lanes.launches
    copies = _ext.lane_rows.copies
    got = tsl.binary_slice_lanes(x, lp, window)
    assert tsl.binary_slice_lanes.launches == k1
    assert tsl.binary_slice_f64_lanes.launches == k10 + 1
    assert _ext.lane_rows.copies == copies + (not _ext.rows_aligned(x))
    assert _ext.rows_aligned(x) == (x.stride(0) % 2 == 0)
    assert torch.equal(got, tsl.binary_slice(x, lp, window))
    if T >= 3 * 128 + 5:
        assert int((got != 0).sum()) > 0


# T at the edges of the 64-sample tiles of K12-K15: 1 sample, a tile less
# 1, a tile, a tile and 1, two tiles and 1
_TILE64_T_EDGES = [1, 63, 64, 65, 129]
# rows of the f64 lanes as the card tests hand them to K12-K14: ``odd
# stride`` always goes through a padded copy, ``wider`` (a view of rows
# padded to an even stride, and 2 doubles more) never
_F64_ROW_FORMS = ("odd_stride", "wider")


@pytest.mark.parametrize("T", [4000, 3 * 128 + 5, *_TILE64_T_EDGES])
@pytest.mark.parametrize("lanes,rows", [(300, "as_they_are"),
                                        (45, "strided"),
                                        (1, "as_they_are"),
                                        (33, "as_they_are"),
                                        *((45, f) for f in _F64_ROW_FORMS),
                                        (70, "f64_specials")])
@pytest.mark.parametrize("window", [1, 16, 256])
def test_four_level_slicer_f64_kernel_matches_twin(cuda, window, lanes, rows,
                                                   T):
    """K12 equals the f64 twin bitwise (and the twin on the CPU);
    four_level_slice_lanes routes float64 to it, never to K8.  Rows at an
    odd stride (``odd_stride``; ``strided``, T + 5 doubles apart, where T
    is even; any of odd T) go through a padded copy, the others
    (``wider``: a view of rows at an even stride) as they lie; NaN, +-inf,
    +-1e300, negative subnormals and -0.0 (``f64_specials``) reach the ring
    and the threshold."""
    from pymodem_tpu_torch import _ext

    x, lp = _f64_rows(lanes, "strided" if rows == "strided" else
                      "as_they_are", T, cuda)
    if rows in _F64_ROW_FORMS:
        x = _f64_row_form(x, rows)
        assert _ext.rows_aligned(x) == (rows == "wider")
    elif rows == "f64_specials":
        x = _f64_specials(x, 47)
    demap = (2, 0, 3, 1)
    k8 = tsl.four_level_slice_lanes.launches
    k12 = tsl.four_level_slice_f64_lanes.launches
    copies = _ext.lane_rows.copies
    got = tsl.four_level_slice_lanes(x, lp, demap, window)
    assert tsl.four_level_slice_lanes.launches == k8
    assert tsl.four_level_slice_f64_lanes.launches == k12 + 1
    assert _ext.rows_aligned(x) == (x.stride(0) % 2 == 0)
    assert _ext.lane_rows.copies == copies + (not _ext.rows_aligned(x))
    want = tsl.four_level_slice(x, lp, demap, window)
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), tsl.four_level_slice(
        x.cpu(), lp.cpu(), demap, window))
    if T >= 3 * 128 + 5 and rows != "f64_specials":
        assert int((got != 0).sum()) > 0


def _f64_loop_case(device, lanes, n_rows, T, seed=5):
    """Input rows, 15 lane rows of PLL_PARAMS + AGC_PARAMS around an
    AFSK-PLL chain at 8 kHz, each lane's row, and the f64 NCO tables."""
    from pymodem_tpu_torch.dsp import window_design as wd

    g = np.random.default_rng(seed)
    t = np.arange(T) / 8000.0
    x = (2e3 * np.sin(2 * np.pi * (1700.0 + 100.0 * np.sign(np.sin(
        2 * np.pi * 150.0 * t)))[None] * t) + 3e2 * g.standard_normal(
        (n_rows, T)))
    rows = np.zeros((15, lanes))
    rows[0], rows[1] = 2 * np.pi / 8000, 1700.0 + g.random(lanes)
    rows[2], rows[3], rows[4] = 256 / (2 * np.pi), 0.0147, 0.97
    rows[5], rows[6], rows[7], rows[8] = 0.03, 0.01, 0.002, 40.0
    rows[9] = g.random(lanes)
    rows[10], rows[11] = 30.0, 3.0
    rows[12], rows[13], rows[14] = 0.5, 1 / 8000, 1.0
    sine, cos = tloops.f64_nco_tables(wd.nco_wavetable(256, 1.0))
    rol = g.integers(0, n_rows, lanes).astype(np.int32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return to(x), to(rows), to(rol), to(sine), to(cos)


@pytest.mark.parametrize("T", [4000, 3 * 128 + 5, *_K11_T_EDGES])
@pytest.mark.parametrize("lanes,n_rows", [(1, 1), (200, 7), (33, 33),
                                          (45, "strided"), (70, "special")])
@pytest.mark.parametrize("kind", ["afsk_pll", "bpsk"])
def test_coherent_loop_f64_kernel_matches_twin(cuda, kind, lanes, n_rows, T):
    """K11, both kinds, on shared rows (``row_of_lane``): bitwise equal to
    the f64 twin; afsk_pll_lanes and bpsk_costas_lanes route float64 to
    it, never to K2 or K3.  ``strided``: one row a lane, a view of rows
    T + 5 doubles apart (a padded copy where that is odd); ``special``:
    row 0 zero for its first 40 samples (the envelope stays 0 and x
    passes) and a NaN in row 1, both read by lanes (NaNs equal as NaNs).
    Rows of odd T go through a padded copy, and the output is then a view
    of padded rows."""
    from pymodem_tpu_torch import _ext

    x, rows, rol, sine, cos = _f64_loop_case(
        cuda, lanes, lanes if isinstance(n_rows, str) else n_rows, T)
    if n_rows == "strided":
        wide = x.new_zeros((lanes, T + 5))
        wide[:, :T] = x
        x = wide[:, :T]
        rol = torch.arange(lanes, dtype=torch.int32, device=cuda)
    elif n_rows == "special":
        x[0, :40] = 0.0
        x[1, T // 2] = float("nan")
        rol[:2] = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    f32 = (tloops.afsk_pll_lanes.launches, tloops.bpsk_costas_lanes.launches)
    k11 = tloops.coherent_loop_f64_lanes.launches
    copies = _ext.lane_rows.copies
    if kind == "afsk_pll":
        got = tloops.afsk_pll_lanes(x, rows, sine, rol)
        want = tloops.afsk_pll(x, rows, sine, rol)
    else:
        got = tloops.bpsk_costas_lanes(x, rows, sine, cos, rol)
        want = tloops.bpsk_costas(x, rows, sine, cos, rol)
    assert (tloops.afsk_pll_lanes.launches,
            tloops.bpsk_costas_lanes.launches) == f32
    assert tloops.coherent_loop_f64_lanes.launches == k11 + 1
    assert _ext.rows_aligned(x) == (x.stride(0) % 2 == 0)
    assert _ext.lane_rows.copies == copies + (not _ext.rows_aligned(x))
    assert got.dtype == torch.float64 and got.shape == (lanes, T)
    if n_rows == "special":
        assert _same_bits(got, want) and bool(got.isnan().any())
        assert bool((got[0, :40] == 0).all())
    else:
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)


def test_f64_wrappers_refuse_mixed_dtypes(cuda):
    """Float64 on the card never gives way to an f32 kernel nor to a twin:
    the wrappers of K13-K16 refuse float32 parameters or tables beside
    float64 samples, and a float64 row beside a float32 one."""
    x = torch.zeros(2, 64, dtype=torch.float64, device=cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    f64 = dict(dtype=torch.float64, device=cuda)
    tables = [torch.zeros(256, **f64)] * 2
    with pytest.raises(ValueError, match="float64"):
        tagc.agc_lanes(x, torch.zeros(5, 2, **f32))
    with pytest.raises(ValueError, match="float64"):
        tloops.qpsk_costas_lanes(x, torch.zeros(17, 2, **f32), *tables)
    with pytest.raises(ValueError, match="float64"):
        tloops.qpsk_costas_lanes(x, torch.zeros(12, 2, **f64),
                                 tables[0].float(), tables[1])
    pd = torch.zeros(1, 64 * 64, dtype=torch.int32, device=cuda)
    index = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float64"):
        tloops.mpsk_loop_lanes(x, x.float(), torch.zeros(12, 2, **f64),
                               *tables, pd, index)
    with pytest.raises(ValueError, match="int32"):
        tloops.mpsk_loop_lanes(x, x, torch.zeros(12, 2, **f64), *tables,
                               pd.long(), index)
    with pytest.raises(ValueError, match="float64"):
        tsl.quadrature_slice_lanes(x, x.float(), torch.ones(2, 2, **f64),
                                   (0, 1, 3, 2), 3, 2)
    with pytest.raises(ValueError, match="float64"):
        tsl.quadrature_slice_lanes(x, x, torch.ones(2, 2, **f32),
                                   (0, 1, 3, 2), 3, 2)


# the f64 PSK kernels K13-K16, on inputs around the presets at 44.1 kHz


def _f64_psk_rows(values, L, device, vary=None):
    return _rows(values, L, device, vary).double()


def _f64_tables(device):
    from pymodem_tpu_torch.dsp import window_design as wd

    return tuple(torch.from_numpy(t).to(device) for t in
                 tloops.f64_nco_tables(wd.nco_wavetable(256, 1.0)))


def _f64_row_form(x, form):
    """``x`` (n, T) as a view of rows at an odd stride (T, or T + 1 where T
    is even), or of rows at an even stride past T (``_F64_ROW_FORMS``)."""
    T = x.shape[1]
    width = T | 1 if form == "odd_stride" else -(-T // 2) * 2 + 2
    wide = x.new_zeros((x.shape[0], width))
    wide[:, :T] = x
    return wide[:, :T]


@pytest.mark.parametrize("T", [4000, 3 * 128 + 5, *_TILE64_T_EDGES])
@pytest.mark.parametrize("rows", ["as_they_are", "strided", "special",
                                  *_F64_ROW_FORMS, "f64_specials"])
@pytest.mark.parametrize("lanes", [1, 45, 118, 33])
def test_agc_f64_kernel_matches_twin(cuda, lanes, rows, T):
    """K13 equals the f64 twin bitwise (NaN, -0.0 and zero samples too;
    ``f64_specials``: +-inf, +-1e300 and negative subnormals as well);
    agc_lanes routes float64 to it, never to K4.  Rows a view of wider
    rows (``strided``, T + 5 doubles apart) are taken as they lie where
    that stride is even and through a padded copy where it is odd, rows at
    an odd stride always through the copy, a view of rows at an even
    stride never; the output is then a view of padded rows."""
    from pymodem_tpu_torch import _ext

    x = _carrier(3, lanes, T, cuda).double() * 7.0
    if rows == "special" and lanes >= 6:
        x = _special(x, 31)
    elif rows == "f64_specials":
        x = _f64_specials(x, 33)
    if rows == "strided":
        wide = x.new_zeros((lanes, T + 5))
        wide[:, :T] = x
        x = wide[:, :T]
    elif rows in _F64_ROW_FORMS:
        x = _f64_row_form(x, rows)
        assert _ext.rows_aligned(x) == (rows == "wider")
    lp = _f64_psk_rows(_AGC_ROWS, lanes, cuda)
    k4, k13 = tagc.agc_lanes.launches, tagc.agc_f64_lanes.launches
    copies = _ext.lane_rows.copies
    got = tagc.agc_lanes(x, lp)
    want = tagc.agc_follower(x, lp)
    torch.cuda.synchronize()
    assert tagc.agc_lanes.launches == k4
    assert tagc.agc_f64_lanes.launches == k13 + 1
    assert _ext.rows_aligned(x) == (x.stride(0) % 2 == 0)
    assert _ext.lane_rows.copies == copies + (not _ext.rows_aligned(x))
    assert got.dtype == torch.float64 and got.shape == (lanes, T)
    assert _same_bits(got, want)


# K14's cases: C chains of 37 lanes on 37 shared rows (0: 200 lanes on
# their own rows), one lane, 33 lanes (a block and one lane), and 2 chains
# on shared rows at an odd stride, as a view of wider rows, or with NaN,
# +-inf, +-1e300, negative subnormals and -0.0
_K14_CASES = [0, 1, 8, "one_lane", "33_lanes", *_F64_ROW_FORMS,
              "f64_specials"]


@pytest.mark.parametrize("T", [4000, 3 * 128 + 5, *_TILE64_T_EDGES])
@pytest.mark.parametrize("chains", _K14_CASES,
                         ids=["identity", "shared_1", "shared_8", "one_lane",
                              "33_lanes", "odd_stride", "wider_rows",
                              "f64_specials"])
@pytest.mark.parametrize("n_rows", [17, 12], ids=["agc_fused", "loop_only"])
def test_qpsk_costas_f64_kernel_matches_twin(cuda, n_rows, chains, T):
    """K14 in both row forms (17 rows: three warps, the AGC off the lanes'
    chain; 12: two), on lanes of their own rows or C chains of 37 lanes on
    37 shared rows (``row_of_lane``), one lane or 33: bitwise equal to the
    f64 twin (NaNs equal as NaNs); qpsk_costas_lanes routes float64 to
    it, never to K5.  Rows at an odd stride, and any of odd T, go through
    a padded copy, and the outputs are then views of padded rows; a view
    of rows at an even stride is taken as it lies."""
    from pymodem_tpu_torch import _ext

    if chains in ("one_lane", "33_lanes"):
        n_in = L = 1 if chains == "one_lane" else 33
    else:
        n_in = 200 if chains == 0 else 37
        L = 200 if chains == 0 else 37 * (chains if isinstance(chains, int)
                                          else 2)
    re, _ = _carrier(9, n_in, T, cuda, iq=True)
    x = (re * 3.0).double().contiguous()
    if chains in _F64_ROW_FORMS:
        x = _f64_row_form(x, chains)
        assert _ext.rows_aligned(x) == (chains == "wider")
    elif chains == "f64_specials":
        x = _f64_specials(x, 45)
    row_of_lane = None if n_in == L else torch.arange(
        n_in, dtype=torch.int32, device=cuda).repeat(L // n_in)
    lp = _f64_psk_rows((_QPSK_ROWS + _AGC_ROWS)[:n_rows], L, cuda, vary=1)
    tables = _f64_tables(cuda)
    k5 = tloops.qpsk_costas_lanes.launches
    k14 = tloops.qpsk_costas_f64_lanes.launches
    copies = _ext.lane_rows.copies
    got = tloops.qpsk_costas_lanes(x, lp, *tables, row_of_lane)
    want = tloops.qpsk_costas(x, lp, *tables, row_of_lane)
    torch.cuda.synchronize()
    assert tloops.qpsk_costas_lanes.launches == k5
    assert tloops.qpsk_costas_f64_lanes.launches == k14 + 1
    assert _ext.rows_aligned(x) == (x.stride(0) % 2 == 0)
    assert _ext.lane_rows.copies == copies + (not _ext.rows_aligned(x))
    for g, w in zip(got, want):
        assert g.shape == (L, T) and g.dtype == torch.float64
        if chains == "f64_specials":
            assert _same_bits(g, w) and bool(g.isnan().any() or T < 64)
        else:
            assert torch.isfinite(g).all() and torch.equal(g, w)


@pytest.mark.parametrize("n_rows", [17, 12], ids=["agc_fused", "loop_only"])
def test_qpsk_costas_f64_kernel_special_rows(cuda, n_rows):
    """Zero, -0.0 and NaN samples: K14 and its twin agree bit for bit (a
    NaN takes the sign -1, as the twin's compare gives it)."""
    re, _ = _carrier(10, 100, 1000, cuda, iq=True)
    x = _special(re * 3.0, 18).double()
    lp = _f64_psk_rows((_QPSK_ROWS + _AGC_ROWS)[:n_rows], 100, cuda, vary=1)
    tables = _f64_tables(cuda)
    got = tloops.qpsk_costas_lanes(x, lp, *tables)
    want = tloops.qpsk_costas(x, lp, *tables)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w)


def _f64_specials(x, seed):
    """``x`` with NaN, +-inf, negative subnormals, +-1e300 (past every int
    range once scaled) and -0.0 sprinkled over its samples."""
    g = np.random.default_rng(seed)
    x = x.clone()
    for value, frac in ((float("nan"), 0.01), (float("inf"), 0.005),
                        (-float("inf"), 0.005), (-4.9e-324, 0.02),
                        (-2.5e-310, 0.02), (1e300, 0.005), (-1e300, 0.005),
                        (-0.0, 0.02)):
        x[torch.from_numpy(g.random(tuple(x.shape)) < frac)
          .to(x.device)] = value
    return x


def _two_strides(a, b):
    """``a`` and ``b`` as views of rows 16-byte aligned at two strides, T
    rounded up to 2 doubles and 2 more."""
    T = a.shape[1]
    return _wider(a, T % 2), _wider(b, T % 2 + 2)


# K15's cases: (rows, detector tables); 3 tables of 4096 doubles are the
# most its shared memory stages beside the tiles, 4 and 24 are read
# through the read-only cache
_K15_CASES = [("identity", 1), ("identity", 3), ("identity", 4),
              ("identity", 24), ("shared", 2), ("one_lane", 1),
              ("two_strides", 1), ("special", 1)]
# T at the edges of K15's 64-sample tiles
_K15_T_EDGES = [1, 63, 64, 65, 129]


@pytest.mark.parametrize("T", [4000, 3 * 128 + 5, *_K15_T_EDGES])
@pytest.mark.parametrize("rows,n_gains", _K15_CASES,
                         ids=[f"{r}_{n}_gains" for r, n in _K15_CASES])
def test_mpsk_loop_f64_kernel_matches_twin(cuda, rows, n_gains, T):
    """K15 on lanes of one or several detector tables (the reference's
    qpsk_error_table; staged as doubles up to the shared-memory cap, past
    it read through the cache), on their own rows (200 lanes, not a
    multiple of 32, or one lane), rows shared by 8 chains, rails at two
    aligned strides (one padded copy) or rows with NaN, +-inf, negative
    subnormals and values past the int range: bitwise equal to the f64
    twin (NaNs equal as NaNs); mpsk_loop_lanes routes float64 to it, never
    to K6."""
    from pymodem_tpu_torch import _ext
    from pymodem_tpu_torch.dsp import window_design as wd

    L = 1 if rows == "one_lane" else 200
    re, im, lp, _, index, row_of_lane = _mpsk_inputs(
        L, T, n_gains, rows == "shared", cuda)
    re, im, lp = re.double(), im.double(), lp.double()
    if rows == "two_strides":
        re, im = _two_strides(re, im)
    elif rows == "special":
        re, im = _f64_specials(re, 41), _f64_specials(im, 42)
    tables = torch.from_numpy(np.stack([
        wd.qpsk_error_table(64, 8.0 + 2.0 * k).astype(np.int32).reshape(-1)
        for k in range(n_gains)])).to(cuda)
    assert tloops.mpsk_f64_tables_staged(tables.numel()) == (n_gains <= 3)
    k6 = tloops.mpsk_loop_lanes.launches
    k15 = tloops.mpsk_loop_f64_lanes.launches
    copies = _ext.lane_rows.copies
    got = tloops.mpsk_loop_lanes(re, im, lp, *_f64_tables(cuda), tables,
                                 index, row_of_lane)
    want = tloops.mpsk_loop(re, im, lp, *_f64_tables(cuda), tables, index,
                            row_of_lane)
    torch.cuda.synchronize()
    assert tloops.mpsk_loop_lanes.launches == k6
    assert tloops.mpsk_loop_f64_lanes.launches == k15 + 1
    assert _ext.lane_rows.copies == copies + (
        0 if _ext.pair_aligned(re, im) else 1 if rows == "two_strides"
        else 2)
    for g, w in zip(got, want):
        assert g.shape == (L, T) and g.dtype == torch.float64
        if rows == "special":
            assert _same_bits(g, w) and bool(g.isnan().any() or T < 64)
        else:
            assert torch.isfinite(g).all() and torch.equal(g, w)


# T at the edges of K16's 128-sample tiles
_K16_T_EDGES = [1, 127, 128, 129, 257]


@pytest.mark.parametrize("T", [3000, 3 * 128 + 5, *_K16_T_EDGES])
@pytest.mark.parametrize("window", [1, 8, 32, 256])
@pytest.mark.parametrize("bps", [1, 2])
@pytest.mark.parametrize("rows", ["as_they_are", "strided", "one_lane",
                                  "two_strides", "special"])
def test_quadrature_slicer_f64_kernel_matches_twin(cuda, rows, bps, window,
                                                   T):
    """K16 on 300 lanes (not a multiple of 32) or one lane, rows as they
    are, a view of wider rows, rails at two aligned strides (one padded
    copy) or with NaN, +-inf and negative subnormals (which decide and
    cross as negatives): bitwise equal to the f64 twin (and the twin on
    the CPU); quadrature_slice_lanes routes float64 to it, never to K7."""
    from pymodem_tpu_torch import _ext

    L = 1 if rows == "one_lane" else 300
    i_l, lp = _f64_rows(L, "strided" if rows == "strided" else
                        "as_they_are", T, cuda)
    q_l, _ = _lanes(7, L, T, cuda)
    q_l = _wider(q_l.double(), 5) if rows == "strided" else q_l.double()
    if rows == "two_strides":
        i_l, q_l = _two_strides(i_l, q_l)
    elif rows == "special":
        i_l, q_l = _f64_specials(i_l, 43), _f64_specials(q_l, 44)
    demap, mask = _quad_demap(bps)
    k7 = tsl.quadrature_slice_lanes.launches
    k16 = tsl.quadrature_slice_f64_lanes.launches
    copies = _ext.lane_rows.copies
    got = tsl.quadrature_slice_lanes(i_l, q_l, lp, demap, mask, bps, window)
    want = tsl.quadrature_slice(i_l, q_l, lp, demap, mask, bps, window)
    torch.cuda.synchronize()
    assert tsl.quadrature_slice_lanes.launches == k7
    assert tsl.quadrature_slice_f64_lanes.launches == k16 + 1
    assert _ext.lane_rows.copies == copies + (
        0 if _ext.pair_aligned(i_l, q_l) else 1 if rows == "two_strides"
        else 2)
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), tsl.quadrature_slice(
        i_l.cpu(), q_l.cpu(), lp.cpu(), demap, mask, bps, window))
    if T >= 3 * 128 + 5 and L > 1:
        assert bool(((got & 0x100) != 0).any())


def test_f64_run_plan_on_the_card_matches_cpu(cuda):
    """A small f64 run_plan on the card (K11, K10, the FIRs as float64
    DGEMMs) gives the same packets and report as on the CPU (the twins,
    conv1d)."""
    from pymodem_tpu_torch.config import ReportSpec, RunPlan
    from pymodem_tpu_torch.runtime import executor

    chains, sent, audio = _pll_stream_case()
    plan = RunPlan(chains=tuple(chains),
                   reports=(ReportSpec("decoded", style="decoded_headers"),))
    k11 = tloops.coherent_loop_f64_lanes.launches
    out = {dev: executor.run_plan(plan, audio, 8000.0, resilient=False,
                                  device=dev, dtype=torch.float64)
           for dev in ("cpu", "cuda")}
    assert tloops.coherent_loop_f64_lanes.launches > k11
    assert out["cuda"].reports == out["cpu"].reports
    keys = {dev: [(list(p.data), p.streamaddress) for ch in
                  r.aggregate.chains for p in ch] for dev, r in out.items()}
    assert keys["cuda"] == keys["cpu"]
    assert f"Unique, valid packets:  {len(sent)}\n" in out["cuda"].reports[0]
