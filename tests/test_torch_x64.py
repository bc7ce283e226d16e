"""The port's float64 parity mode on the CPU, against pymodem_tpu at x64:
the sequential executor, the FIRs, loops and slicers, and the f64
kernels' routes (the banked runtime, the CLI and the multi-recording entry
points at f64: test_torch_x64_banked.py).

The JAX side runs with ``jax_enable_x64`` on (tests/conftest.py) and
``dtype=jnp.float64``, its reference-parity mode; the port runs
``dtype=torch.float64`` on the CPU, through the plain twins of its f64
kernels (K10 binary slicer, K11 AGC + AFSK PLL / BPSK Costas loop, K12
four-level slicer, K13 AGC, K14 QPSK Costas loop, K15 MPSK loop, K16
quadrature slicer), whose bitwise equality with the kernels is held on
the card (tests/test_torch_cuda.py, chip_smoke.py):

* the sequential executor (the mode's default route): packets and report
  text equal to the JAX package's ``run_plan`` for every family: ``afsk``,
  ``afsk_pll``, ``bpsk``, ``fsk`` (binary slicer), 4FSK, ``qpsk`` (Costas
  QPSK-2400) and ``mpsk`` (QPSK-2400 and BPSK-1200);
* the FIRs at f64 against the JAX package's ``direct`` engine, to 1e-12
  of the peak (the CPU's ``conv1d``, and the banded DGEMM engine the card
  runs at f64);
* the slicers' twins at f64 against the JAX f64 scans, compacted, bitwise;
  the loops' and the AGC's twins against the JAX f64 scans;
* on a device that is not the CPU every family's f64 demod and slicer
  reach the f64 kernels' entry points (none of the f32 kernels').
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_x64_cases import F64, FAMILIES, REPORTS, _audio, _packets
from pymodem_tpu.config import RunPlan as JRunPlan
from pymodem_tpu.config import build_chain_spec as jbuild_chain_spec
from pymodem_tpu.dsp import fir as jfir
from pymodem_tpu.dsp import loops as jloops
from pymodem_tpu.ops import slicers as jsl
from pymodem_tpu.runtime import executor as jexecutor
from pymodem_tpu_torch import _ext
from pymodem_tpu_torch import config as tconfig
from pymodem_tpu_torch import modems as tmodems
from pymodem_tpu_torch.config import RunPlan, build_chain_spec
from pymodem_tpu_torch.device import resolve_dtype
from pymodem_tpu_torch.dsp import fir as tfir
from pymodem_tpu_torch.dsp import loops as tloops
from pymodem_tpu_torch.dsp import window_design as wd
from pymodem_tpu_torch.mode import X64_VAR
from pymodem_tpu_torch.ops import slicers as tsl
from pymodem_tpu_torch.runtime import executor as texecutor


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_plan_f64_matches_jax(family):
    """The executor at f64: packets and report text equal to the JAX
    package's f64 run_plan, every frame decoded, none rejected."""
    line, rate = FAMILIES[family]
    sent, x = _audio(family)
    got = texecutor.run_plan(
        RunPlan(chains=(build_chain_spec(rate, line),), reports=REPORTS), x,
        rate, resilient=False, device="cpu", dtype=F64)
    want = jexecutor.run_plan(
        JRunPlan(chains=(jbuild_chain_spec(rate, line),), reports=REPORTS),
        x, rate, dtype=jnp.float64, resilient=False)
    assert _packets(got.aggregate.chains) == _packets(want.aggregate.chains)
    assert got.reports == want.reports
    assert f"Unique, valid packets:  {len(sent)}\n" in got.reports[0]
    assert got.aggregate.count_bad() == 0


def test_run_chain_takes_the_modes_dtype(monkeypatch):
    """dtype=None is the mode's: float64 under PYMODEM_TPU_TORCH_X64, as
    the JAX package's None under jax_enable_x64."""
    line, rate = FAMILIES["fsk9600"]
    chain = build_chain_spec(rate, line)
    _, x = _audio("fsk9600")
    monkeypatch.setenv(X64_VAR, "1")
    assert resolve_dtype(None) == F64
    by_mode = texecutor.run_chain(chain, x, device="cpu")
    assert _packets([by_mode]) == _packets(
        [texecutor.run_chain(chain, x, device="cpu", dtype=F64)])
    for off in ("0", "", "false"):
        monkeypatch.setenv(X64_VAR, off)
        assert resolve_dtype(None) == torch.float32


def test_f64_without_a_gpu_raises():
    """No fallback: an f64 run on the default device, the card, raises
    without a GPU; the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    line, rate = FAMILIES["fsk9600"]
    _, x = _audio("fsk9600")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        texecutor.run_chain(build_chain_spec(rate, line), x, dtype=F64)



# ---------------------------------------------------------------------------
# FIRs, loops and slicers at f64
# ---------------------------------------------------------------------------


def _direct(x, taps):
    return np.asarray(jfir.fir_valid_nd(jnp.asarray(x), jnp.asarray(taps),
                                        "direct"))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n_taps", [7, 133])
def test_fir_f64_matches_jax_direct(n_taps, rng):
    """Each FIR entry point at f64 on the CPU (``conv1d``), and the banded
    DGEMM engine that the card runs at f64, within 1e-12 of the peak of
    the JAX package's direct convolution."""
    x = rng.standard_normal((3, 2, 2000))
    taps = rng.standard_normal((2, n_taps))
    xt, tt = torch.from_numpy(x), torch.from_numpy(taps)
    assert tfir._method(xt, n_taps) == "direct"
    assert tfir._method(xt.to("meta"), n_taps) == "matmul"
    want = _direct(x, taps[0])
    _close(tfir.fir_valid_nd(xt, taps[0]), want)
    y, n_tiles, nout = tfir._matmul(xt, tfir._band(tt[0]), n_taps)
    _close(y.reshape(3, 2, n_tiles * 128)[..., :nout], want)
    got = tfir.fir_valid_multi(xt, taps)
    for k in range(2):
        _close(got[k], _direct(x, taps[k]))
    got = tfir.fir_valid_per_chain(xt[:2], taps)
    for c in range(2):
        _close(got[c], _direct(x[c], taps[c]))


# the quadrature slicer presets' (demap, state_mask, bits_per_symbol)
_QUAD = {name: (tuple(p["demap"]), p["state_mask"], p["bits_per_symbol"])
         for name, p in tconfig._QUAD_SLICER_PRESETS.items()}


def _slicer_input(rng, n_lanes, n):
    sps = 8000.0 / 300.0
    idx = (np.arange(n) / sps).astype(np.int64)
    sym = rng.integers(0, 4, (n_lanes, idx.max() + 2)) * 2.0 - 3.0
    return sym[:, idx] + 0.3 * rng.standard_normal((n_lanes, n)), sps


@pytest.mark.parametrize("kind", ["binary", "4level", "quadrature"])
def test_slicer_twins_f64_match_jax_scans(kind, rng):
    """The twins of K10, K12 and K16 at f64, compacted as the bank
    compacts them (windowed emissions), equal the JAX f64 scans'
    compact_bytes bitwise: bytes, addresses and counts.  The quadrature
    slicer runs the QPSK-2400 demap, state mask and 2 bits a decision."""
    x, sps = _slicer_input(rng, 6 if kind == "quadrature" else 3, 6000)
    lock, demap = 0.75, (2, 0, 3, 1)
    bps = 1 if kind == "binary" else 2
    window = tsl.safe_compact_window(sps, lock, bps)
    rows = torch.tensor([[sps] * 3, [lock] * 3], dtype=F64)
    xt = torch.from_numpy(x)
    quad = _QUAD["qpsk_2400"]
    if kind == "binary":
        enc = tsl.binary_slice_lanes(xt, rows, window)
    elif kind == "4level":
        enc = tsl.four_level_slice_lanes(xt, rows, demap, window)
    else:
        enc = tsl.quadrature_slice_lanes(xt[:3], xt[3:], rows, *quad,
                                         window)
    cap = 512
    got = tsl.compact_windowed(enc, window, cap)
    for lane in range(3):
        xl = jnp.asarray(x[lane])
        if kind == "binary":
            out = jsl.binary_slice(xl, sps, lock)
        elif kind == "4level":
            out = jsl.four_level_slice(xl, sps, lock,
                                       jnp.asarray(demap, jnp.int32), 0.0)
        else:
            out = jsl.quadrature_slice(xl, jnp.asarray(x[3 + lane]), sps,
                                       lock, jnp.asarray(quad[0], jnp.int32),
                                       quad[1], quad[2])
        want = jsl.compact_bytes(out, cap, window)
        assert int(want[2]) > 10
        for g, w in zip(got, want):
            assert np.array_equal(g[lane].numpy(), np.asarray(w)), lane


def test_bpsk_twin_f64_matches_scan():
    """K11's bpsk twin at f64, with the reference wavetable and its
    quarter-turn shift as the two tables, against the JAX package's AGC
    then f64 Costas scan on the same band-passed input: to 1e-12 of the
    peak.  (The afsk_pll kind: tests/test_torch_loops.py.)"""
    from pymodem_tpu import modems as jmodems

    spec = build_chain_spec(44100.0, FAMILIES["bpsk1200"][0]).modem
    _, x16 = _audio("bpsk1200")
    jparams = jmodems.bpsk_params(spec)
    filtered = jfir.fir_valid(jnp.asarray(x16[:8000], jnp.float64),
                              jnp.asarray(jparams.input_bpf), "direct")
    want = np.asarray(jloops.bpsk_costas(
        jmodems._apply_agc(filtered, jparams.agc),
        jmodems._loop_params(spec, jnp.float64)))
    x = torch.from_numpy(np.array(filtered))
    rows = torch.cat([tmodems._loop_rows(spec, F64),
                      tmodems.agc_rows(tmodems.bpsk_params(spec).agc, x)])
    got = tloops.bpsk_costas_lanes(x[None], rows.contiguous(),
                                   *tmodems.nco_tables("cpu", F64))[0]
    _close(got, want)


def _psk_inputs(family, n=8000):
    """(port spec, JAX spec, JAX params, JAX's f64 band-passed first n
    samples of the family's executor audio, the same as a torch tensor)."""
    from pymodem_tpu import modems as jmodems

    line, rate = FAMILIES[family]
    spec = build_chain_spec(rate, line).modem
    jspec = jbuild_chain_spec(rate, line).modem
    _, x16 = _audio(family)
    jparams = jmodems.build_params(jspec)
    filtered = jfir.fir_valid(jnp.asarray(x16[:n], jnp.float64),
                              jnp.asarray(jparams.input_bpf), "direct")
    return spec, jspec, jparams, filtered, torch.from_numpy(
        np.array(filtered))


def test_agc_twin_f64_matches_scan():
    """K13's twin (``agc_follower``, through ``agc_lanes``) at f64 against
    the JAX package's f64 ``agc_apply`` on the same band-passed MPSK
    input: bitwise."""
    from pymodem_tpu import modems as jmodems
    from pymodem_tpu_torch.dsp import agc as tagc

    spec, _, jparams, filtered, x = _psk_inputs("mpsk_qpsk2400")
    want = np.asarray(jmodems._apply_agc(filtered, jparams.agc))
    rows = tmodems.agc_rows(tmodems.build_params(spec).agc, x)
    got = tagc.agc_lanes(x[None], rows.contiguous())[0]
    assert got.dtype == F64
    assert np.array_equal(got.numpy(), want)


def test_qpsk_twin_f64_matches_scan():
    """K14's twin at f64 (the bank's form: 17 rows, the AGC fused) against
    the JAX package's AGC then f64 ``qpsk_costas`` scan on the same
    band-passed input: both rails to 1e-12 of the peak (XLA's CPU scan
    contracts multiply-adds where the twin rounds each operation), and
    the 12-row form on the leveled input equal to the 17-row form."""
    from pymodem_tpu import modems as jmodems
    from pymodem_tpu.dsp.loops import QPSKLoopParams

    spec, jspec, jparams, filtered, x = _psk_inputs("qpsk2400_costas")
    leveled = jmodems._apply_agc(filtered, jparams.agc)
    bb0, ba1 = wd.iir1_lpf_coefs(spec.sample_rate, spec.branch_lpf_cutoff,
                                 1.0)
    want = jloops.qpsk_costas(leveled, QPSKLoopParams(
        base=jmodems._loop_params(jspec, jnp.float64),
        branch_b0=jnp.asarray(bb0, jnp.float64),
        branch_a1=jnp.asarray(ba1, jnp.float64)))
    # the loop's and branch IIR's 12 rows, then the AGC's over the JAX
    # package's band-passed input
    params = tmodems.build_params(spec)
    _, rows = tmodems.coherent_loop_inputs(spec, params, torch.from_numpy(
        _audio("qpsk2400_costas")[1][:8000].astype(np.float64)))
    rows = torch.cat([rows[:12], tmodems.agc_rows(params.agc, x)]
                     ).contiguous()
    tables = tmodems.nco_tables("cpu", F64)
    got = tloops.qpsk_costas_lanes(x[None], rows, *tables)
    for g, w in zip(got, want):
        _close(g[0], np.asarray(w))
    alone = tloops.qpsk_costas_lanes(
        torch.from_numpy(np.array(leveled))[None], rows[:12].contiguous(),
        *tables)
    for g, a in zip(got, alone):
        assert torch.equal(g, a)


def test_mpsk_twin_f64_matches_scan():
    """K15's twin at f64 against the JAX package's f64 ``mpsk_loop`` (its
    table detector, control rounded half to even) on the same analytic
    input, the JAX package's own: both rails to 1e-12 of the peak (XLA's
    CPU scan contracts multiply-adds), the detector table the reference's
    ``qpsk_error_table``."""
    from pymodem_tpu import modems as jmodems
    from pymodem_tpu.dsp.loops import MPSKLoopParams

    spec, jspec, jparams, filtered, _ = _psk_inputs("mpsk_qpsk2400")
    leveled = jmodems._apply_agc(filtered, jparams.agc)
    imag = jfir.fir_valid(leveled, jnp.asarray(jparams.hilbert), "direct")
    d = jparams.hilbert_delay
    real = leveled[d:-d]
    want = jloops.mpsk_loop(real, imag, MPSKLoopParams(
        base=jmodems._loop_params(jspec, jnp.float64),
        pd_table=jnp.asarray(jparams.pd_table),
        pd_granularity=jnp.asarray(jspec.pd_granularity, jnp.int32),
        pd_gain=jnp.asarray(jspec.pd_gain, jnp.float64)))
    _, _, rows, table, index = tmodems.mpsk_loop_inputs(
        spec, tmodems.build_params(spec), torch.from_numpy(
            np.zeros(4000, np.float64)))
    assert np.array_equal(table[0].numpy(),
                          np.asarray(jparams.pd_table).reshape(-1))
    got = tloops.mpsk_loop_lanes(
        torch.from_numpy(np.array(real))[None],
        torch.from_numpy(np.array(imag))[None], rows,
        *tmodems.nco_tables("cpu", F64), table, index)
    for g, w in zip(got, want):
        _close(g[0], np.asarray(w))


# ---------------------------------------------------------------------------
# every family and entry point at f64
# ---------------------------------------------------------------------------

# the C entry points of the f32 loop and slicer kernels (K1-K8)
F32_ENTRIES = {"binary_slice_lanes", "afsk_pll_lanes", "bpsk_costas_lanes",
               "agc_lanes", "qpsk_costas_lanes", "mpsk_loop_lanes",
               "quadrature_slice_lanes", "four_level_slice_lanes"}


@pytest.fixture
def launched(monkeypatch):
    """The C entry points launched, by name, with the CUDA checks relaxed
    to any device that is not the CPU: the kernels' routes run on ``meta``
    tensors here, shapes and dtypes but no data, and nothing launches."""
    names = []

    def require(device, dtype, **tensors):
        assert device.type != "cpu"
        for name, t in tensors.items():
            assert t.device == device and t.dtype == dtype, name

    monkeypatch.setattr(_ext, "require", require)
    monkeypatch.setattr(_ext, "require_rows", require)
    monkeypatch.setattr(_ext, "launch",
                        lambda name, device, argtypes, *args:
                        names.append(name))
    return names


def test_f64_tensors_off_the_cpu_reach_the_f64_kernels(launched):
    """A float64 tensor on a device that is not the CPU goes from each
    routed wrapper to its f64 kernel's entry point, never its twin nor an
    f32 kernel: K13 from ``agc_lanes``, K14 from ``qpsk_costas_lanes``
    (17 rows with the AGC fused, 12 without, on shared rows), K15 from
    ``mpsk_loop_lanes``, K16 from ``quadrature_slice_lanes``, and the
    results are float64 (the emissions int32) of the lanes' shapes."""
    meta = torch.device("meta")
    L, R, T = 6, 3, 50

    def f64(*shape):
        return torch.empty(shape, dtype=F64, device=meta)

    rol = torch.empty(L, dtype=torch.int32, device=meta)
    tabs = (f64(256), f64(256))
    from pymodem_tpu_torch.dsp import agc as tagc

    counters = (tagc.agc_f64_lanes, tloops.qpsk_costas_f64_lanes,
                tloops.mpsk_loop_f64_lanes, tsl.quadrature_slice_f64_lanes)
    before = [c.launches for c in counters]
    assert tagc.agc_lanes(f64(L, T), f64(5, L)).shape == (L, T)
    for n in (17, 12):
        i, q = tloops.qpsk_costas_lanes(f64(R, T), f64(n, L), *tabs, rol)
        assert i.dtype == q.dtype == F64 and i.shape == q.shape == (L, T)
    re, im = tloops.mpsk_loop_lanes(
        f64(R, T), f64(R, T), f64(12, L), *tabs,
        torch.empty((1, 64 * 64), dtype=torch.int32, device=meta),
        torch.empty(L, dtype=torch.int32, device=meta), rol)
    assert re.dtype == F64 and re.shape == im.shape == (L, T)
    enc = tsl.quadrature_slice_lanes(f64(L, T), f64(L, T), f64(2, L),
                                     *_QUAD["qpsk_2400"], window=8)
    assert enc.dtype == torch.int32 and enc.shape == (L, -(-T // 8))
    assert launched == ["agc_f64_lanes", "qpsk_costas_f64_lanes",
                        "qpsk_costas_f64_lanes", "mpsk_loop_f64_lanes",
                        "quadrature_slice_f64_lanes"]
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 2, 1, 1]


@pytest.mark.parametrize("family", ["qpsk2400_costas", "mpsk_qpsk2400",
                                    "mpsk_bpsk1200"])
def test_psk_chains_at_f64_run_their_f64_kernels(family, launched):
    """The executor's whole-recording demod and slicer of a ``qpsk`` or
    ``mpsk`` chain at f64 on a device that is not the CPU launch the f64
    kernels and only those: K14 then K16 for the Costas chain, K13, K15
    and K16 for the MPSK chains."""
    line, rate = FAMILIES[family]
    chain = build_chain_spec(rate, line)
    audio = torch.empty(int(rate), dtype=F64, device="meta")
    base = tmodems.demod(chain.modem, tmodems.build_params(chain.modem),
                         audio)
    sl = chain.slicer
    tsl.quadrature_slice_lanes(
        base[0][None], base[1][None],
        texecutor.slicer_lane_params(sl, audio.device, F64), sl.demap,
        sl.state_mask, sl.bits_per_symbol)
    assert not F32_ENTRIES & set(launched)
    assert launched == (
        ["qpsk_costas_f64_lanes", "quadrature_slice_f64_lanes"]
        if chain.modem.kind == "qpsk" else
        ["agc_f64_lanes", "mpsk_loop_f64_lanes",
         "quadrature_slice_f64_lanes"])

