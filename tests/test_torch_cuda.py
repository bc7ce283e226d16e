"""The port's CUDA kernels (K1-K8) on the card, against their plain twins.

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


@pytest.mark.parametrize("window", [1, 8, 64])
def test_binary_slicer_kernel_matches_twin(cuda, window):
    x, lp = _lanes(0, 300, 3000, cuda)
    before = tsl.binary_slice_lanes.launches
    got = tsl.binary_slice_lanes(x, lp, window)
    want = tsl.binary_slice(x, lp, window)
    torch.cuda.synchronize()
    assert tsl.binary_slice_lanes.launches == before + 1
    assert torch.equal(got, want)
    assert bool(((got & 0x100) != 0).any())


def test_afsk_pll_kernel_matches_twin(cuda):
    g = np.random.default_rng(1)
    L, T = 200, 3000
    t = np.arange(T) / 8000.0
    x = 2.0 * np.sin(2 * np.pi * (1700.0 + g.uniform(-8, 8, (L, 1))) * t)
    x = torch.from_numpy((x + 0.3 * g.standard_normal((L, T)))
                         .astype(np.float32)).to(cuda)
    rows = torch.tensor([2 * np.pi / 8000, 1700.0, 256 / (2 * np.pi), 0.0557,
                         0.8886, 540.0, 900.0, 1e-4, 50.0, 0.0, 0.1, 0.01,
                         1.0, 1.25e-4, 1.0], dtype=torch.float32)
    lp = rows[:, None].repeat(1, L)
    lp[1] += torch.linspace(-5, 5, L)
    lp = lp.to(cuda).contiguous()
    table = torch.from_numpy(tloops.nco_sine_table()).to(cuda)
    before = tloops.afsk_pll_lanes.launches
    got = tloops.afsk_pll_lanes(x, lp, table)
    want = tloops.afsk_pll(x, lp, table)
    torch.cuda.synchronize()
    assert tloops.afsk_pll_lanes.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


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


def test_agc_kernel_matches_twin(cuda):
    x = _carrier(3, 150, 4000, cuda) * torch.linspace(0.1, 3, 150,
                                                      device=cuda)[:, None]
    lp = _rows(_AGC_ROWS, 150, cuda)
    before = tagc.agc_lanes.launches
    got = tagc.agc_lanes(x, lp)
    want = tagc.agc_follower(x, lp)
    torch.cuda.synchronize()
    assert tagc.agc_lanes.launches == before + 1
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_bpsk_costas_kernel_matches_twin(cuda):
    x = _carrier(4, 200, 4000, cuda)
    lp = _rows(_PLL_ROWS + _AGC_ROWS, 200, cuda, vary=1)
    sine, cosine = _tables(cuda)
    before = tloops.bpsk_costas_lanes.launches
    got = tloops.bpsk_costas_lanes(x, lp, sine, cosine)
    want = tloops.bpsk_costas(x, lp, sine, cosine)
    torch.cuda.synchronize()
    assert tloops.bpsk_costas_lanes.launches == before + 1
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize(
    "gains", [(32.0, 20.0), tuple(8.0 + 2.0 * np.arange(24))],
    ids=["2_gains", "24_gains"])
def test_mpsk_loop_kernel_matches_twin(cuda, gains):
    """Lanes of several detector gains, each reading its own table; 24
    tables of 16 KB are more than a block's shared memory would hold."""
    L = 200
    re, im = _carrier(5, L, 4000, cuda, iq=True)
    rows = [2 * np.pi / 44100, 1500.0, 256 / (2 * np.pi), 0.0175, 0.965,
            14400 / 65536 * 0.3, 14400 / 65536, 0.3 / 2000, 31.25, -31.25,
            32.0, 64.0]
    lp = _rows(rows, L, cuda, vary=1)
    sine, cosine = _tables(cuda)
    tables = torch.from_numpy(np.stack([
        tloops.pd_error_table(64, k) for k in gains])).to(cuda)
    index = (torch.arange(L, device=cuda) % len(gains)).to(torch.int32)
    before = tloops.mpsk_loop_lanes.launches
    got = tloops.mpsk_loop_lanes(re, im, lp, sine, cosine, tables, index)
    want = tloops.mpsk_loop(re, im, lp, sine, cosine, tables, index)
    torch.cuda.synchronize()
    assert tloops.mpsk_loop_lanes.launches == before + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)


@pytest.mark.parametrize("window", [1, 32])
@pytest.mark.parametrize("bps", [1, 2])
def test_quadrature_slicer_kernel_matches_twin(cuda, bps, window):
    i_l, lp = _lanes(6, 300, 3000, cuda)
    q_l, _ = _lanes(7, 300, 3000, cuda)
    demap = ((3, 1, 2, 0, 2, 3, 0, 1, 1, 0, 3, 2, 0, 2, 1, 3) if bps == 2
             else (0, 0, 1, 1))
    mask = 0xF if bps == 2 else 0x3
    before = tsl.quadrature_slice_lanes.launches
    got = tsl.quadrature_slice_lanes(i_l, q_l, lp, demap, mask, bps, window)
    want = tsl.quadrature_slice(i_l, q_l, lp, demap, mask, bps, window)
    torch.cuda.synchronize()
    assert tsl.quadrature_slice_lanes.launches == before + 1
    assert torch.equal(got, want)
    assert bool(((got & 0x100) != 0).any())


def _four_level(seed, n_lanes, n_samples, device):
    """(L, T) f32 noisy 4-level symbols (+-1, +-3) at 10 +- 0.4 samples
    per symbol, each lane with its own gain, and their (2, L) rows."""
    g = np.random.default_rng(seed)
    sps = g.choice([9.6, 10.0, 10.4], n_lanes).astype(np.float32)
    lock = g.choice([0.985, 0.9], n_lanes).astype(np.float32)
    idx = np.arange(n_samples)[None, :] / sps[:, None]
    sym = g.choice([-3.0, -1.0, 1.0, 3.0],
                   (n_lanes, int(idx.max()) + 2))
    x = np.take_along_axis(sym, idx.astype(np.int64), 1)
    x = (x * g.uniform(0.2, 2.0, (n_lanes, 1))
         + 0.3 * g.standard_normal(x.shape)).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(np.stack([sps, lock])).to(device))


@pytest.mark.parametrize("window", [1, 32])
def test_four_level_slicer_kernel_matches_twin(cuda, window):
    x, lp = _four_level(8, 300, 4000, cuda)
    demap = (2, 0, 3, 1)
    before = tsl.four_level_slice_lanes.launches
    got = tsl.four_level_slice_lanes(x, lp, demap, window)
    want = tsl.four_level_slice(x, lp, demap, window)
    torch.cuda.synchronize()
    assert tsl.four_level_slice_lanes.launches == before + 1
    assert torch.equal(got, want)
    assert bool(((got & 0x100) != 0).any())


# the Costas "2400" preset's loop at 44.1 kHz (PLL_PARAMS order), its branch
# IIR (b0, a1), then AGC rows with normal 2
_QPSK_ROWS = [2 * np.pi / 44100, 1800.0, 256 / (2 * np.pi), 0.014048,
              0.971903, 45.0, 450.0, 2e-4, 87.5, 0.0, 0.078930, 0.842139]


@pytest.mark.parametrize("n_rows", [17, 12], ids=["agc_fused", "loop_only"])
def test_qpsk_costas_kernel_matches_twin(cuda, n_rows):
    re, im = _carrier(9, 200, 4000, cuda, iq=True)
    x = (re * 3.0).contiguous()
    lp = _rows((_QPSK_ROWS + _AGC_ROWS)[:n_rows], 200, cuda, vary=1)
    sine, cosine = _tables(cuda)
    before = tloops.qpsk_costas_lanes.launches
    got = tloops.qpsk_costas_lanes(x, lp, sine, cosine)
    want = tloops.qpsk_costas(x, lp, sine, cosine)
    torch.cuda.synchronize()
    assert tloops.qpsk_costas_lanes.launches == before + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, lp = _lanes(2, 8, 100, cuda)
    with pytest.raises(ValueError, match="float32"):
        tsl.binary_slice_lanes(x.double(), lp.double())
    with pytest.raises(ValueError, match="contiguous"):
        tsl.binary_slice_lanes(x.t().contiguous().t(), lp)
    with pytest.raises(ValueError, match="window"):
        tsl.binary_slice_lanes(x, lp, window=3)
    with pytest.raises(ValueError, match="float32"):
        tsl.quadrature_slice_lanes(x, x.double(), lp, (0, 0, 1, 1), 3, 1)
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
    with pytest.raises(ValueError, match="demap"):
        tsl.four_level_slice_lanes(x, lp, (2, 0, 3))
    with pytest.raises(ValueError, match="window"):
        tsl.four_level_slice_lanes(x, lp, (2, 0, 3, 1), window=512)
    with pytest.raises(ValueError, match="float32"):
        tsl.four_level_slice_lanes(x.double(), lp.double(), (2, 0, 3, 1))
    with pytest.raises(ValueError, match="17"):
        tloops.qpsk_costas_lanes(x, rows15, sine, cosine)
    rows17 = _rows(_QPSK_ROWS + _AGC_ROWS, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tloops.qpsk_costas_lanes(x.t().contiguous().t(), rows17, sine,
                                 cosine)
    with pytest.raises(ValueError, match="NCO tables"):
        tloops.qpsk_costas_lanes(x, rows17, sine[:128], cosine)
