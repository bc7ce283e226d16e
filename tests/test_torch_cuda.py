"""The port's CUDA kernels on the card, against their plain twins.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it also
runs where JAX is not installed (the tests' conftest.py imports JAX, so run
it there with ``python -m pytest --noconftest tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

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


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, lp = _lanes(2, 8, 100, cuda)
    with pytest.raises(ValueError, match="float32"):
        tsl.binary_slice_lanes(x.double(), lp.double())
    with pytest.raises(ValueError, match="contiguous"):
        tsl.binary_slice_lanes(x.t().contiguous().t(), lp)
    with pytest.raises(ValueError, match="window"):
        tsl.binary_slice_lanes(x, lp, window=3)
