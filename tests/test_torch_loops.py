"""Kernel K2's plain twin (AFSK PLL with fused AGC) against pymodem_tpu.

Three references, as the JAX package's own loop tests use them:

* the Pallas kernel ``loop_lanes_pallas(kind="afsk_pll")`` with 15 rows
  (AGC fused), in interpret mode, with the twin reading XLA's own ``sin``
  of the 256 quantised angles;
* the JAX package's ``agc_apply`` then its ``afsk_pll`` scan;
* the f64 scan with the reference wavetable.

Why f32 is not compared directly.  The twin (like K2, built with
-fmad=false) rounds every multiply and add separately, in the JAX op order.
XLA:CPU fuses some multiply-adds into FMAs (one rounding instead of two),
and the PLL's feedback carries a last-bit difference along the lane, so the
twin and XLA part after a handful of samples.  ``_reference`` is the loop
in plain numpy f32, op by op as the twin, with a chosen set of multiply-adds
fused at each step; it shows the cause exactly:

* reference with nothing fused == twin, bitwise;
* reference with the fusions of ``PALLAS_FUSED`` == the Pallas kernel in
  interpret mode, bitwise (on a host without FMA XLA fuses nothing, and the
  kernel then equals the unfused reference);
* reference with ``SCAN_FUSED`` == the unroll-4 scan, bitwise: XLA fuses a
  different subset at each of the four positions of the unrolled body.
  These subsets were found by trying, for each position, every choice of
  the three sites below until all samples agreed.

f64 (no visible FMA effect): 1e-12 relative.  The AGC follower alone has no
multiply-add and matches bitwise.  On the card K2 equals the twin bitwise
(tests/test_torch_cuda.py, chip_smoke.py).

Lanes may read shared input rows (``row_of_lane``, a pre-shared bank's B
band-passed rows for its C chains): the twin on shared rows equals the
same model on the rows copied out lane by lane, and the bank's basebands
equal those of its C*B-row form.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pymodem_tpu import modems as jmodems
from pymodem_tpu.config import AFSKPLLModemSpec
from pymodem_tpu.dsp.agc import agc_apply as jagc
from pymodem_tpu.dsp.loops import TWO_PI, LoopParams, afsk_pll as jpll
from pymodem_tpu.dsp.pallas_loops import (
    agc_lane_params as jagc_rows,
    lane_params_from_loop as jloop_rows,
    loop_lanes_pallas,
)
from pymodem_tpu_torch import modems as tmodems
from pymodem_tpu_torch.config import build_chain_spec
from pymodem_tpu_torch.dsp import agc as tagc
from pymodem_tpu_torch.dsp import loops as tloops
from pymodem_tpu_torch.runtime import bank as tbank

C, B, T = 2, 3, 700
AGC_FIELDS = ("scaled_attack", "scaled_decay", "sustain_time",
              "sustain_increment", "target")


def _specs():
    return [AFSKPLLModemSpec(sample_rate=8000.0, carrier_freq=1700.0 + 10 * i)
            for i in range(C)]


def _case(rng, dtype, n_samples=T):
    """Inputs, loop and AGC constants of C chains x B blocks of
    ``n_samples`` at ``dtype``."""
    T = n_samples
    specs = _specs()
    # a band-passed AFSK-like signal: mark/space tones 10 Hz apart around
    # the carriers, random symbols at 300 baud, plus noise -- the loop
    # tracks it, as on the decode path (white noise alone leaves the PLL
    # unlocked and chaotic, so last-bit differences would grow unbounded)
    bits = rng.integers(0, 2, (C, B, T // 26 + 1))[..., (np.arange(T) // 26)]
    freq = 1695.0 + 10.0 * bits + 10.0 * np.arange(C)[:, None, None]
    phase = 2 * np.pi * np.cumsum(freq, axis=-1) / 8000.0
    x = (2.0 * np.sin(phase + rng.uniform(0, 6, (C, B, 1)))
         + 0.2 * rng.standard_normal((C, B, T))).astype(dtype)
    loops = [jmodems._loop_params_host(s) for s in specs]
    loop = {k: np.stack([np.asarray(getattr(lp, k), dtype) for lp in loops])
            for k in LoopParams._fields}
    agcs = [jmodems._agc_params(s.agc, s.sample_rate) for s in specs]
    agc = {k: np.array([getattr(a, k) for a in agcs], dtype)
           for k in AGC_FIELDS}
    normals = x.reshape(C, -1).max(axis=1)
    return x, loop, agc, normals


def _port_rows(loop, agc, normals, dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return torch.cat([
        tloops.lane_params_from_loop(
            {k: torch.from_numpy(v) for k, v in loop.items()}, C, B, tdt),
        tloops.agc_lane_params({k: torch.from_numpy(v)
                                for k, v in agc.items()},
                               torch.from_numpy(normals), C, B, tdt),
    ])


def _scan(x, loop, agc, normals):
    """agc_apply -> afsk_pll scans per (chain, block), JAX package."""
    out = np.empty_like(x)
    for c in range(C):
        lp = LoopParams(**{k: jnp.asarray(v[c]) for k, v in loop.items()})
        for b in range(B):
            y = jagc(jnp.asarray(x[c, b]), agc["scaled_attack"][c],
                     agc["scaled_decay"][c], agc["sustain_time"][c],
                     agc["sustain_increment"][c], agc["target"][c],
                     unroll=4, normal=jnp.asarray(normals[c]))
            out[c, b] = np.asarray(jpll(y, lp, unroll=4))
    return out


# multiply-adds XLA:CPU may fuse: the NCO phase update
# phase + phase_scale*(f + control), the IIR's feed-forward sum
# b0*mixer + b0*mixer_prev (fused on either product) and its feedback add
# (...) + a1*y_prev
PHASE, FF_MIXER, FF_PREV, FEEDBACK = "phase", "ff_mixer", "ff_prev", "fb"
PALLAS_FUSED = (frozenset({PHASE, FF_MIXER, FEEDBACK}),) * 4
SCAN_FUSED = (frozenset({FF_PREV, FEEDBACK}), frozenset({PHASE}),
              frozenset({FEEDBACK}), frozenset({PHASE, FF_MIXER, FEEDBACK}))
UNFUSED = (frozenset(),) * 4


def _fma(a, b, c):
    """f32 a*b + c rounded once.  numpy has no fma: the product of two f32
    is exact in f64, and the f64 sum rounded to f32 differs from a true fma
    only when it lands on an f32 tie."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _reference(x, rows, table, fused=UNFUSED):
    """The f32 AFSK PLL with fused AGC over (L, T) lanes in numpy, op by op
    as the twin, with the multiply-adds named in ``fused[t % 4]`` fused at
    step t."""
    (ps, sf, isc, b0, a1, gp, gain, pi_i, lim, i0,
     att, dec, sus_t, sus_inc, target) = rows
    zero = np.zeros(x.shape[0], np.float32)
    phase = control = mixer_prev = y_prev = env = sustain = zero
    integral = i0
    two_pi = np.float32(TWO_PI)
    out = np.empty_like(x)
    for t in range(x.shape[1]):
        f = fused[t % 4]
        x_t = x[:, t]
        rising = np.abs(x_t) > env
        env = np.where(rising, np.minimum(env + att, np.abs(x_t)), env)
        sustain = np.where(rising, zero, sustain)
        env = np.where(sustain >= sus_t, np.maximum(env - dec, zero), env)
        sustain = sustain + sus_inc
        with np.errstate(divide="ignore", invalid="ignore"):
            x_t = np.where(env != 0, target * x_t / env, x_t)
        step = sf + control
        p = _fma(ps, step, phase) if PHASE in f else phase + ps * step
        for _ in range(2):
            p = np.where(p >= two_pi, p - two_pi, p)
        for _ in range(2):
            p = np.where(p < 0, p + two_pi, p)
        phase = p
        mixer = x_t * table[(p * isc).astype(np.int32) & 255]
        if FF_MIXER in f:
            ff = _fma(b0, mixer, b0 * mixer_prev)
        elif FF_PREV in f:
            ff = _fma(b0, mixer_prev, b0 * mixer)
        else:
            ff = b0 * mixer + b0 * mixer_prev
        y = _fma(a1, y_prev, ff) if FEEDBACK in f else ff + a1 * y_prev
        prop = gp * y
        integral = np.minimum(np.maximum(integral + gain * (pi_i * y), -lim),
                              lim)
        control = prop + integral
        out[:, t] = prop
        mixer_prev, y_prev = mixer, y
    return out


def _assert_fused(want, x, rows, table, fused):
    """``want`` (from XLA:CPU) is the reference with ``fused`` -- or, on a
    host without FMA, the unfused one -- bitwise, and it differs from the
    unfused order somewhere (else the fusion model shows nothing)."""
    plain = _reference(x, rows, table)
    if np.array_equal(want, plain):  # XLA fused nothing here
        return
    np.testing.assert_array_equal(want, _reference(x, rows, table, fused))


def _xla_sine_table():
    angle = (np.arange(256, dtype=np.float32)
             * np.float32(TWO_PI / 256))
    return torch.from_numpy(np.array(jnp.sin(jnp.asarray(angle))))


def test_lane_rows_match_jax_bitwise(rng):
    x, loop, agc, normals = _case(rng, np.float32)
    want = np.concatenate([
        np.asarray(jloop_rows(LoopParams(**loop), C, B)),
        np.asarray(jagc_rows(type("A", (), agc), jnp.asarray(normals), C, B)),
    ])
    got = _port_rows(loop, agc, normals, np.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_twin_matches_pallas_kernel(rng):
    x, loop, agc, normals = _case(rng, np.float32)
    rows = _port_rows(loop, agc, normals, np.float32)
    xl = x.reshape(C * B, T)
    table = _xla_sine_table()
    want = np.asarray(loop_lanes_pallas(
        jnp.asarray(xl), jnp.asarray(rows.numpy()), "afsk_pll",
        wavetable_size=256, tc=256))
    got = tloops.afsk_pll_lanes(torch.from_numpy(xl), rows, table).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, _reference(xl, rows.numpy(), table.numpy()))
    _assert_fused(want, xl, rows.numpy(), table.numpy(), PALLAS_FUSED)


def test_twin_on_shared_rows_matches_pallas_kernel(rng):
    """C chains on B shared rows (``row_of_lane``, lane c*B + b on row b),
    T not a multiple of 4 or of 128: the twin equals the reference on the
    rows copied out lane by lane, bitwise, and the Pallas kernel in
    interpret mode fed those rows equals the reference with its fusions."""
    n = 3 * 128 + 5
    x, loop, agc, normals = _case(rng, np.float32, n)
    rows = _port_rows(loop, agc, normals, np.float32)
    shared = x[0]  # (B, n): every chain reads chain 0's rows
    row_of_lane = np.tile(np.arange(B, dtype=np.int32), C)
    expanded = np.ascontiguousarray(shared[row_of_lane])
    table = _xla_sine_table()
    got = tloops.afsk_pll_lanes(torch.from_numpy(shared), rows, table,
                                torch.from_numpy(row_of_lane)).numpy()
    assert got.shape == (C * B, n)
    np.testing.assert_array_equal(
        got, _reference(expanded, rows.numpy(), table.numpy()))
    want = np.asarray(loop_lanes_pallas(
        jnp.asarray(expanded), jnp.asarray(rows.numpy()), "afsk_pll",
        wavetable_size=256, tc=256))
    _assert_fused(want, expanded, rows.numpy(), table.numpy(), PALLAS_FUSED)


def _pll_sweep_bank():
    """A pre-shared 3-chain AFSK-PLL carrier sweep (chip_smoke's
    ``pll_sweep8`` cut to 3 chains) and 3 random blocks for it."""
    line = {
        "object_name": "pll", "object_type": "demod_chain",
        "modem": {"type": "afsk_pll", "config": "300", "options": {}},
        "slicer": {"type": "binary", "config": "300", "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                               "invert": "no"}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }
    base = build_chain_spec(8000.0, line)
    chains = [replace(base, name=f"pll{i}",
                      modem=replace(base.modem, carrier_freq=1696.0 + i))
              for i in range(C)]
    (bank,) = tbank.group_chains(chains, "cpu")
    blocks = np.random.default_rng(7).standard_normal((B, 900)) * 1e3
    return bank, torch.from_numpy(blocks.astype(np.float32))


def test_pre_shared_bank_hands_k2_its_shared_rows():
    """``coherent_loop_inputs`` on a pre-shared bank: its B band-passed rows
    once, lane c*B + b on row b, and the 15 rows of all C*B lanes."""
    bank, blocks = _pll_sweep_bank()
    assert "pre_shared" in bank.params
    x, rows, row_of_lane = tbank.coherent_loop_inputs(bank.params, blocks)
    assert x.shape[0] == B and x.is_contiguous()
    assert row_of_lane.dtype == torch.int32
    assert row_of_lane.tolist() == list(range(B)) * C
    assert rows.shape == (15, C * B)


def test_pre_shared_bank_basebands_equal_copied_rows(monkeypatch):
    """The bank's K2 basebands on its B shared rows equal, bitwise, those of
    the C*B-row form (every lane on its own copy of its row)."""
    bank, blocks = _pll_sweep_bank()
    got = tbank.bank_basebands(bank, blocks)
    shared_rows = tbank._shared_rows
    monkeypatch.setattr(tbank, "_shared_rows",
                        lambda x, shared: shared_rows(x, False))
    want = tbank.bank_basebands(bank, blocks)
    assert got.shape == want.shape and got.shape[:2] == (C, B)
    assert torch.equal(got, want)


def test_twin_matches_agc_then_pll_scan(rng):
    x, loop, agc, normals = _case(rng, np.float32)
    rows = _port_rows(loop, agc, normals, np.float32)
    xl = x.reshape(C * B, T)
    want = _scan(x, loop, agc, normals).reshape(C * B, T)
    for table in (_xla_sine_table(), torch.from_numpy(tloops.nco_sine_table())):
        got = tloops.afsk_pll(torch.from_numpy(xl), rows, table).numpy()
        np.testing.assert_array_equal(
            got, _reference(xl, rows.numpy(), table.numpy()))
    _assert_fused(want, xl, rows.numpy(), _xla_sine_table().numpy(),
                  SCAN_FUSED)


def test_twin_f64_matches_scan_with_wavetable(rng):
    x, loop, agc, normals = _case(rng, np.float64)
    want = _scan(x, loop, agc, normals)
    got = tloops.afsk_pll(torch.from_numpy(x.reshape(C * B, T)),
                          _port_rows(loop, agc, normals, np.float64),
                          torch.from_numpy(loop["wavetable"][0]))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy().reshape(C, B, T), want,
                               rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_agc_matches_bitwise(dtype, rng):
    spec = _specs()[0]
    a = jmodems._agc_params(spec.agc, spec.sample_rate)
    x = (rng.standard_normal(T) * 3.0).astype(dtype)
    args = [np.asarray(getattr(a, k), dtype) for k in AGC_FIELDS]
    want = np.asarray(jagc(jnp.asarray(x), *args, unroll=4))
    # the follower over one lane, its steps scaled by the signed max of x
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    rows = tloops.agc_lane_params(
        {k: torch.from_numpy(v[None]) for k, v in zip(AGC_FIELDS, args)},
        torch.from_numpy(x.max()[None]), 1, 1, tdt)
    got = tagc.agc_follower(torch.from_numpy(x[None]), rows).numpy()[0]
    np.testing.assert_array_equal(got, want)


def test_host_params_match_jax():
    spec = _specs()[1]
    for a, b in ((tmodems._loop_params_host(spec),
                  jmodems._loop_params_host(spec)),
                 (tmodems.afsk_pll_params(spec),
                  jmodems.afsk_pll_params(spec))):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(fa, dtype=object)
                                          if hasattr(fa, "_fields")
                                          else fa, fb)


def test_sine_table_is_sin_of_quantised_angles():
    """f32(sin(f64(angle))): within one f32 ulp of XLA's own sin on every
    one of the 256 angles (they differ on a handful)."""
    got = tloops.nco_sine_table()
    xla = _xla_sine_table().numpy()
    assert got.shape == (256,) and got.dtype == np.float32
    ulp = np.spacing(np.abs(xla).astype(np.float32))
    assert (np.abs(got - xla) <= ulp).all()
