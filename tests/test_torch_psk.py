"""The PSK families of the port against pymodem_tpu: kernels K3, K4 and K6's
plain twins, the phase-detector table, bank parameters, and packets end to
end for the three bank shapes the port's smoke run decodes on the card.

Method, as for K2 (tests/test_torch_loops.py).  Each twin rounds every
multiply and add on its own, in the JAX op order, as its kernel does (built
with -fmad=false).  ``_bpsk_reference`` and ``_mpsk_reference`` are the same
loops in plain numpy f32 with a chosen set of multiply-adds fused into one
rounding; the twin equals the reference with nothing fused, bitwise, and
XLA-CPU's output (the Pallas kernel in interpret mode, the scan at
``unroll=1``) equals the reference with the sites XLA fuses, bitwise:

* K3 (Pallas ``bpsk`` and the ``bpsk_costas`` scan): the NCO phase update
  and the PI integral update;
* K6 (Pallas ``mpsk`` and the ``mpsk_loop`` scan): the NCO phase update and
  the first product of each rail of the complex mix.

(On a host without FMA XLA fuses nothing and its output equals the unfused
reference.)  The fused sets were found by trying every subset of the
candidate sites; the scans run at ``unroll=1`` so that every step fuses
alike.  The twins read XLA's own ``sin``/``cos`` of the 256 quantised
angles here; the kernels and twins read ``nco_sine_table``/``nco_cos_table``
on the card.  K4 (the AGC follower) has no multiply-add and matches
bitwise outright.  K6's phase detector is a table: equal to the JAX
package's f32 ``_pd_lookup`` at every folded pair, bitwise, and to the
Pallas kernel's minimax atan at the presets' g = 64.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pymodem_tpu import modems as jmodems
from pymodem_tpu.config import (
    BPSKModemSpec,
    build_chain_spec as jbuild_chain_spec,
    _mpsk_preset,
)
from pymodem_tpu.dsp.agc import agc_apply as jagc
from pymodem_tpu.dsp.loops import (
    TWO_PI,
    LoopParams,
    MPSKLoopParams,
    _pd_lookup,
    bpsk_costas as jcostas,
    mpsk_loop as jmpsk,
)
from pymodem_tpu.dsp.pallas_loops import (
    agc_lane_params as jagc_rows,
    iq_loop_lanes_pallas,
    lane_params_from_loop as jloop_rows,
    loop_lanes_pallas,
)
from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu_torch import modems as tmodems
from pymodem_tpu_torch.config import build_chain_spec
from pymodem_tpu_torch.convert import bank_params_from_jax
from pymodem_tpu_torch.dsp import agc as tagc
from pymodem_tpu_torch.dsp import loops as tloops
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

RATE = 8000.0
C, B, T = 2, 3, 1500
AGC_FIELDS = ("scaled_attack", "scaled_decay", "sustain_time",
              "sustain_increment", "target")
BPSK_FUSED = frozenset({"phase", "int"})
MPSK_FUSED = frozenset({"phase", "re_a", "im_a"})


def _fma(a, b, c):
    """f32 a*b + c rounded once (the f64 sum of an exact f32 product,
    rounded to f32: differs from a true fma only on an f32 tie)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _xla_tables():
    angle = np.arange(256, dtype=np.float32) * np.float32(TWO_PI / 256)
    return (np.array(jnp.sin(jnp.asarray(angle))),
            np.array(jnp.cos(jnp.asarray(angle))))


def _loop_leaves(specs):
    loops = [jmodems._loop_params_host(s) for s in specs]
    return {k: np.stack([np.asarray(getattr(lp, k), np.float32)
                         for lp in loops]) for k in LoopParams._fields}


def _assert_fused(want, reference, fused):
    """``want`` (XLA-CPU) is ``reference(fused)`` bitwise -- or, on a host
    without FMA, the unfused reference -- and the fusion shows somewhere."""
    plain = reference(frozenset())
    if all(np.array_equal(w, p) for w, p in zip(want, plain)):
        return
    for w, g in zip(want, reference(fused)):
        np.testing.assert_array_equal(w, g)


# ---------------------------------------------------------------------------
# K4: the AGC follower
# ---------------------------------------------------------------------------


def _agc_case(rng):
    specs = [BPSKModemSpec(sample_rate=RATE),
             replace(BPSKModemSpec(sample_rate=RATE),
                     agc=replace(BPSKModemSpec().agc, attack_rate=400.0,
                                 sustain_time=0.05))]
    x = (rng.standard_normal((C, B, T)) * np.array([3.0, 0.5])[:, None, None]
         ).astype(np.float32)
    x[:, :, T // 2:] *= np.float32(0.1)  # a fade the decay must follow
    agcs = [jmodems._agc_params(s.agc, s.sample_rate) for s in specs]
    agc = {k: np.array([getattr(a, k) for a in agcs], np.float32)
           for k in AGC_FIELDS}
    normals = x.reshape(C, -1).max(axis=1)
    return x, agc, normals


def test_agc_twin_matches_pallas_and_scan_bitwise(rng):
    x, agc, normals = _agc_case(rng)
    rows = tloops.agc_lane_params({k: torch.from_numpy(v)
                                   for k, v in agc.items()},
                                  torch.from_numpy(normals), C, B)
    want_rows = np.asarray(jagc_rows(type("A", (), agc), jnp.asarray(normals),
                                     C, B))
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    xl = x.reshape(C * B, T)
    got = tagc.agc_lanes(torch.from_numpy(xl), rows).numpy()
    pallas = np.asarray(loop_lanes_pallas(jnp.asarray(xl),
                                          jnp.asarray(want_rows), "agc",
                                          tc=256))
    np.testing.assert_array_equal(got, pallas)
    for c in range(C):
        for b in range(B):
            scan = jagc(jnp.asarray(x[c, b]), agc["scaled_attack"][c],
                        agc["scaled_decay"][c], agc["sustain_time"][c],
                        agc["sustain_increment"][c], agc["target"][c],
                        unroll=4, normal=jnp.asarray(normals[c]))
            np.testing.assert_array_equal(got[c * B + b], np.asarray(scan))


# ---------------------------------------------------------------------------
# K3: the BPSK Costas loop with the AGC fused
# ---------------------------------------------------------------------------


def _bpsk_case(rng, n_samples=T):
    T = n_samples
    specs = [BPSKModemSpec(sample_rate=RATE, carrier_freq=1500.0 + 3 * i)
             for i in range(C)]
    # +-1 symbols at 300 baud on the chains' carriers, plus noise: the loop
    # locks as on the decode path
    sym = rng.integers(0, 2, (C, B, T // 26 + 1)) * 2 - 1
    t = np.arange(T) / RATE
    carrier = 1500.0 + 3 * np.arange(C)[:, None, None]
    x = (2.0 * sym[..., np.arange(T) // 26]
         * np.cos(2 * np.pi * carrier * t + rng.uniform(0, 6, (C, B, 1)))
         + 0.2 * rng.standard_normal((C, B, T))).astype(np.float32)
    loop = _loop_leaves(specs)
    agcs = [jmodems._agc_params(s.agc, s.sample_rate) for s in specs]
    agc = {k: np.array([getattr(a, k) for a in agcs], np.float32)
           for k in AGC_FIELDS}
    normals = x.reshape(C, -1).max(axis=1)
    rows = np.concatenate([
        np.asarray(jloop_rows(LoopParams(**loop), C, B)),
        np.asarray(jagc_rows(type("A", (), agc), jnp.asarray(normals), C, B)),
    ])
    return x, loop, agc, normals, rows


def _bpsk_reference(x, rows, sine, cosine, fused=frozenset()):
    """The f32 BPSK Costas loop with fused AGC over (L, T) lanes in numpy,
    op by op as the twin, with the multiply-adds named in ``fused`` fused
    at every step."""
    (ps, sf, isc, b0, a1, gp, gain, pi_i, lim, i0,
     att, dec, sus_t, sus_inc, target) = rows
    zero = np.zeros(x.shape[0], np.float32)
    phase = control = e_prev = y_prev = env = sustain = zero
    integral = i0
    two_pi = np.float32(TWO_PI)
    out = np.empty_like(x)
    for t in range(x.shape[1]):
        x_t = x[:, t]
        rising = np.abs(x_t) > env
        env = np.where(rising, np.minimum(env + att, np.abs(x_t)), env)
        sustain = np.where(rising, zero, sustain)
        env = np.where(sustain >= sus_t, np.maximum(env - dec, zero), env)
        sustain = sustain + sus_inc
        with np.errstate(divide="ignore", invalid="ignore"):
            x_t = np.where(env != 0, target * x_t / env, x_t)
        step = sf + control
        p = _fma(ps, step, phase) if "phase" in fused else phase + ps * step
        for _ in range(2):
            p = np.where(p >= two_pi, p - two_pi, p)
        for _ in range(2):
            p = np.where(p < 0, p + two_pi, p)
        phase = p
        idx = (p * isc).astype(np.int32) & 255
        i_mixer = x_t * cosine[idx]
        e = i_mixer * (x_t * -sine[idx])
        y = (b0 * e + b0 * e_prev) + a1 * y_prev
        prop = gp * y
        if "int" in fused:
            acc = _fma(gain, pi_i * y, integral)
        else:
            acc = integral + gain * (pi_i * y)
        integral = np.minimum(np.maximum(acc, -lim), lim)
        control = prop + integral
        out[:, t] = i_mixer
        e_prev, y_prev = e, y
    return out


def test_bpsk_twin_matches_pallas_kernel(rng):
    x, _, _, _, rows = _bpsk_case(rng)
    xl = x.reshape(C * B, T)
    sine, cosine = _xla_tables()
    got = tloops.bpsk_costas_lanes(torch.from_numpy(xl),
                                   torch.from_numpy(rows),
                                   torch.from_numpy(sine),
                                   torch.from_numpy(cosine)).numpy()
    np.testing.assert_array_equal(
        got, _bpsk_reference(xl, rows, sine, cosine))
    want = np.asarray(loop_lanes_pallas(jnp.asarray(xl), jnp.asarray(rows),
                                        "bpsk", wavetable_size=256, tc=256))
    _assert_fused((want,), lambda f: (_bpsk_reference(xl, rows, sine,
                                                      cosine, f),),
                  BPSK_FUSED)


def test_bpsk_twin_on_shared_rows_matches_pallas_kernel(rng):
    """C chains on B shared rows (``row_of_lane``, lane c*B + b on row b),
    T not a multiple of 4 or of 128: the twin equals the reference on the
    rows copied out lane by lane, bitwise, and the Pallas kernel in
    interpret mode fed those rows equals the reference with its fusions."""
    n = 3 * 128 + 5
    x, _, _, _, rows = _bpsk_case(rng, n)
    shared = x[0]  # (B, n): every chain reads chain 0's rows
    row_of_lane = np.tile(np.arange(B, dtype=np.int32), C)
    expanded = np.ascontiguousarray(shared[row_of_lane])
    sine, cosine = _xla_tables()
    got = tloops.bpsk_costas_lanes(
        torch.from_numpy(shared), torch.from_numpy(rows),
        torch.from_numpy(sine), torch.from_numpy(cosine),
        torch.from_numpy(row_of_lane)).numpy()
    assert got.shape == (C * B, n)
    np.testing.assert_array_equal(
        got, _bpsk_reference(expanded, rows, sine, cosine))
    want = np.asarray(loop_lanes_pallas(
        jnp.asarray(expanded), jnp.asarray(rows), "bpsk", wavetable_size=256,
        tc=256))
    _assert_fused((want,), lambda f: (_bpsk_reference(expanded, rows, sine,
                                                      cosine, f),),
                  BPSK_FUSED)


def _bpsk_sweep_bank():
    """A pre-shared 3-chain BPSK-1200 carrier sweep at 8 kHz (chip_smoke's
    ``bpsk1200_sweep8`` cut to 3 chains) and 3 random blocks for it."""
    base = build_chain_spec(RATE, LINES["bpsk"])
    chains = [_variant(base, f"b{i}", carrier_freq=1500 + 0.25 * i)
              for i in range(3)]
    (bank,) = tbank.group_chains(chains, "cpu")
    blocks = np.random.default_rng(8).standard_normal((B, 900)) * 1e3
    return bank, torch.from_numpy(blocks.astype(np.float32))


def test_pre_shared_bank_hands_k3_its_shared_rows():
    """``coherent_loop_inputs`` on a pre-shared BPSK bank: its B band-passed
    rows once, lane c*B + b on row b, and the 15 rows of all C*B lanes."""
    bank, blocks = _bpsk_sweep_bank()
    assert bank.kind == "bpsk" and "pre_shared" in bank.params
    x, rows, row_of_lane = tbank.coherent_loop_inputs(bank.params, blocks)
    assert x.shape[0] == B and x.is_contiguous()
    assert row_of_lane.dtype == torch.int32
    assert row_of_lane.tolist() == list(range(B)) * 3
    assert rows.shape == (15, 3 * B)


def test_pre_shared_bpsk_basebands_equal_copied_rows(monkeypatch):
    """The bank's K3 basebands on its B shared rows equal, bitwise, those of
    the C*B-row form (every lane on its own copy of its row)."""
    bank, blocks = _bpsk_sweep_bank()
    got = tbank.bank_basebands(bank, blocks)
    shared_rows = tbank._shared_rows
    monkeypatch.setattr(tbank, "_shared_rows",
                        lambda x, shared: shared_rows(x, False))
    want = tbank.bank_basebands(bank, blocks)
    assert got.shape == want.shape and got.shape[:2] == (3, B)
    assert torch.equal(got, want)


def test_bpsk_twin_matches_agc_then_costas_scan(rng):
    x, loop, agc, normals, rows = _bpsk_case(rng)
    want = np.empty_like(x)
    for c in range(C):
        lp = LoopParams(**{k: jnp.asarray(v[c]) for k, v in loop.items()})
        for b in range(B):
            y = jagc(jnp.asarray(x[c, b]), agc["scaled_attack"][c],
                     agc["scaled_decay"][c], agc["sustain_time"][c],
                     agc["sustain_increment"][c], agc["target"][c],
                     unroll=4, normal=jnp.asarray(normals[c]))
            want[c, b] = np.asarray(jcostas(y, lp, unroll=1))
    xl = x.reshape(C * B, T)
    sine, cosine = _xla_tables()
    for s, c in ((sine, cosine),
                 (tloops.nco_sine_table(), tloops.nco_cos_table())):
        got = tloops.bpsk_costas(torch.from_numpy(xl), torch.from_numpy(rows),
                                 torch.from_numpy(s), torch.from_numpy(c))
        np.testing.assert_array_equal(got.numpy(),
                                      _bpsk_reference(xl, rows, s, c))
    _assert_fused((want.reshape(C * B, T),),
                  lambda f: (_bpsk_reference(xl, rows, sine, cosine, f),),
                  BPSK_FUSED)


# ---------------------------------------------------------------------------
# K6: the MPSK loop and its phase-detector table
# ---------------------------------------------------------------------------

G, PD_GAIN = 64, 32.0  # every mpsk preset's granularity and gain


def test_pd_table_matches_jax_f32_lookup():
    """Every folded pair (a, b) in [0, g)^2, fed to _pd_lookup as the
    centre of its quantisation cell."""
    a, b = np.meshgrid(np.arange(G), np.arange(G), indexing="ij")
    half = np.float32(G) * np.float32(0.5)
    re = ((a + 0.5) / half).astype(np.float32).ravel()
    im = ((b + 0.5) / half).astype(np.float32).ravel()
    want = np.asarray(jax.jit(_pd_lookup)(
        jnp.asarray(re), jnp.asarray(im), jnp.zeros((G, G), jnp.int32),
        jnp.asarray(G, jnp.int32), jnp.asarray(PD_GAIN, jnp.float32)))
    got = tloops.pd_error_table(G, PD_GAIN)
    assert got.dtype == np.int32 and got.shape == (G * G,)
    np.testing.assert_array_equal(got, want)
    # and the f64 reference table (phase_detector.py) agrees at the presets
    np.testing.assert_array_equal(
        got, jmodems.mpsk_params(_mpsk_preset("qpsk_2400", RATE))
        .pd_table.ravel())


def _mpsk_case(rng):
    specs = [replace(_mpsk_preset("qpsk_2400", RATE),
                     carrier_freq=1500.0 + 3 * i) for i in range(C)]
    sps = RATE / 1200.0
    k = (np.arange(T) / sps).astype(int)
    sym_i = (rng.integers(0, 2, (C, B, k[-1] + 1)) * 2 - 1)[..., k]
    sym_q = (rng.integers(0, 2, (C, B, k[-1] + 1)) * 2 - 1)[..., k]
    w = (2 * np.pi * (1502.0 + 3 * np.arange(C)[:, None, None])
         * np.arange(T) / RATE + rng.uniform(0, 6, (C, B, 1)))
    noise = 0.05 * rng.standard_normal((2, C, B, T))
    re = (0.7 * (sym_i * np.cos(w) - sym_q * np.sin(w)) + noise[0])
    im = (0.7 * (sym_i * np.sin(w) + sym_q * np.cos(w)) + noise[1])
    loop = _loop_leaves(specs)
    rows = np.concatenate([
        np.asarray(jloop_rows(LoopParams(**loop), C, B)),
        np.full((1, C * B), PD_GAIN, np.float32),
        np.full((1, C * B), G, np.float32),
    ])
    return (re.astype(np.float32), im.astype(np.float32), specs, loop, rows)


def _mpsk_reference(re, im, rows, sine, cosine, table, fused=frozenset()):
    """The f32 MPSK loop over (L, T) lane pairs in numpy, op by op as the
    twin, with the multiply-adds named in ``fused`` fused at every step:
    ``re_a``/``im_a`` are the first product of each rail's mix."""
    (ps, sf, isc, b0, a1, gp, gain, pi_i, lim, i0, _, gf) = rows
    zero = np.zeros(re.shape[0], np.float32)
    phase = control = e_prev = y_prev = zero
    integral = i0
    gi = gf.astype(np.int32)
    half = gf * np.float32(0.5)
    two_pi = np.float32(TWO_PI)
    out_re, out_im = np.empty_like(re), np.empty_like(im)
    for t in range(re.shape[1]):
        step = sf + control
        p = _fma(ps, step, phase) if "phase" in fused else phase + ps * step
        for _ in range(2):
            p = np.where(p >= two_pi, p - two_pi, p)
        for _ in range(2):
            p = np.where(p < 0, p + two_pi, p)
        phase = p
        idx = (p * isc).astype(np.int32) & 255
        c, ns = cosine[idx], -sine[idx]
        r_t, i_t = re[:, t], im[:, t]
        if "re_a" in fused:
            o_re = _fma(r_t, c, -(i_t * ns))
        else:
            o_re = (r_t * c) - (i_t * ns)
        if "im_a" in fused:
            o_im = _fma(c, i_t, r_t * ns)
        else:
            o_im = (c * i_t) + (r_t * ns)
        r = np.floor(o_re * half).astype(np.int32)
        i = np.floor(o_im * half).astype(np.int32)
        r = np.where(r >= gi, gi - 1, r)
        i = np.where(i >= gi, gi - 1, i)
        r = np.where(r <= -gi, -(gi - 1), r)
        i = np.where(i <= -gi, -(gi - 1), i)
        rn, inn = r >= 0, i >= 0
        a = np.where(rn, np.where(inn, r, -i), np.where(inn, i, -r))
        b = np.where(rn, np.where(inn, i, r), np.where(inn, -r, -i))
        e = table[a * gi + b].astype(np.float32)
        y = (b0 * e + b0 * e_prev) + a1 * y_prev
        integral = np.minimum(np.maximum(integral + gain * (pi_i * y), -lim),
                              lim)
        control = np.round(gp * y + integral)
        out_re[:, t], out_im[:, t] = o_re, o_im
        e_prev, y_prev = e, y
    return out_re, out_im


def _mpsk_twin(re, im, rows, sine, cosine, table):
    L = re.shape[0]
    return tuple(v.numpy() for v in tloops.mpsk_loop_lanes(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(rows),
        torch.from_numpy(sine), torch.from_numpy(cosine),
        torch.from_numpy(table[None]), torch.zeros(L, dtype=torch.int32)))


def test_mpsk_twin_matches_pallas_kernel(rng):
    re, im, _, _, rows = _mpsk_case(rng)
    rl, il = re.reshape(C * B, T), im.reshape(C * B, T)
    sine, cosine = _xla_tables()
    table = tloops.pd_error_table(G, PD_GAIN)
    got = _mpsk_twin(rl, il, rows, sine, cosine, table)
    for g, w in zip(got, _mpsk_reference(rl, il, rows, sine, cosine, table)):
        np.testing.assert_array_equal(g, w)
    # the Pallas kernel's minimax atan gives this table at g = 64 too
    want = tuple(np.asarray(v) for v in iq_loop_lanes_pallas(
        (jnp.asarray(rl), jnp.asarray(il)), jnp.asarray(rows), "mpsk",
        wavetable_size=256, tc=256))
    _assert_fused(want, lambda f: _mpsk_reference(rl, il, rows, sine,
                                                  cosine, table, f),
                  MPSK_FUSED)


def test_mpsk_twin_matches_scan(rng):
    re, im, specs, loop, rows = _mpsk_case(rng)
    want_re, want_im = np.empty_like(re), np.empty_like(im)
    for c in range(C):
        lp = MPSKLoopParams(
            base=LoopParams(**{k: jnp.asarray(v[c]) for k, v in loop.items()}),
            pd_table=jnp.asarray(jmodems.mpsk_params(specs[c]).pd_table),
            pd_granularity=jnp.asarray(G, jnp.int32),
            pd_gain=jnp.asarray(PD_GAIN, jnp.float32))
        for b in range(B):
            o = jmpsk(jnp.asarray(re[c, b]), jnp.asarray(im[c, b]), lp,
                      unroll=1)
            want_re[c, b], want_im[c, b] = (np.asarray(v) for v in o)
    rl, il = re.reshape(C * B, T), im.reshape(C * B, T)
    sine, cosine = _xla_tables()
    table = tloops.pd_error_table(G, PD_GAIN)
    _assert_fused((want_re.reshape(C * B, T), want_im.reshape(C * B, T)),
                  lambda f: _mpsk_reference(rl, il, rows, sine, cosine,
                                            table, f),
                  MPSK_FUSED)
    got = _mpsk_twin(rl, il, rows, tloops.nco_sine_table(),
                     tloops.nco_cos_table(), table)
    for g, w in zip(got, _mpsk_reference(rl, il, rows,
                                         tloops.nco_sine_table(),
                                         tloops.nco_cos_table(), table)):
        np.testing.assert_array_equal(g, w)


def test_mpsk_twin_picks_each_lanes_table(rng):
    """Lanes of chains with different detector gains read their own
    table."""
    re, im, _, _, rows = _mpsk_case(rng)
    rl, il = re.reshape(C * B, T)[:, :400], im.reshape(C * B, T)[:, :400]
    sine, cosine = _xla_tables()
    tables = np.stack([tloops.pd_error_table(G, PD_GAIN),
                       tloops.pd_error_table(G, 20.0)])
    index = np.repeat(np.arange(C, dtype=np.int32), B)
    got = tloops.mpsk_loop(*(torch.from_numpy(v) for v in (
        rl, il, rows, sine, cosine, tables, index)))
    for c in range(C):
        lanes = slice(c * B, (c + 1) * B)
        want = _mpsk_reference(rl[lanes], il[lanes], rows[:, lanes], sine,
                               cosine, tables[c])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[lanes].numpy(), w)


@pytest.mark.parametrize("shared", [False, True], ids=["identity", "shared"])
def test_mpsk_twin_reads_lane_rows(rng, shared):
    """Lanes that read their input rows through ``row_of_lane`` (the B
    shared rows of a pre-shared bank, lane c*B + b on row b, or a permuted
    identity) give bitwise what the rows copied out lane by lane give; the
    wrapper takes the same route on the CPU."""
    re, im, _, _, rows = _mpsk_case(rng)
    sine, cosine = _xla_tables()
    tables = np.stack([tloops.pd_error_table(G, PD_GAIN)])
    index = np.zeros(C * B, np.int32)
    if shared:
        src_re, src_im = re[0], im[0]  # (B, T)
        row_of_lane = np.tile(np.arange(B, dtype=np.int32), C)
    else:
        src_re, src_im = re.reshape(C * B, T), im.reshape(C * B, T)
        row_of_lane = rng.permutation(C * B).astype(np.int32)
    want = tloops.mpsk_loop(*(torch.from_numpy(np.ascontiguousarray(v))
                              for v in (src_re[row_of_lane],
                                        src_im[row_of_lane], rows, sine,
                                        cosine, tables, index)))
    args = tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in (
        src_re, src_im, rows, sine, cosine, tables, index, row_of_lane))
    for got in (tloops.mpsk_loop(*args), tloops.mpsk_loop_lanes(*args)):
        for g, w in zip(got, want):
            assert g.shape == (C * B, T)
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Host parameters and bank parameters
# ---------------------------------------------------------------------------


def _line(name, modem, mcfg, slicer, scfg, poly="0x3"):
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": modem, "config": mcfg, "options": {}},
        "slicer": {"type": slicer, "config": scfg, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": poly,
                                               "invert": "no"}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }


LINES = {
    "bpsk": _line("BPSK 1200", "bpsk", "1200", "binary", "1200"),
    "qpsk": _line("QPSK 2400", "mpsk", "qpsk_2400", "quadrature",
                  "qpsk_2400", "0x1"),
    "mpsk_bpsk": _line("BPSK 1200 MPSK", "mpsk", "bpsk_1200", "quadrature",
                       "bpsk_1200"),
}


def _variant(spec, name, **modem):
    return replace(spec, name=name, modem=replace(spec.modem, **modem),
                   codec=replace(spec.codec, ident=name))


def _banks(rate, build=jbuild_chain_spec):
    """The smoke run's three bank shapes, cut to 2-3 chains: a BPSK carrier
    sweep, a pre-shared QPSK (mpsk) carrier sweep and a non-shared mpsk
    BPSK pair (AGC attack 500 and 400); and a QPSK bank of three detector
    gains, three phase-detector tables for K6."""
    bp = build(rate, LINES["bpsk"])
    qp = build(rate, LINES["qpsk"])
    mb = build(rate, LINES["mpsk_bpsk"])
    return {
        "bpsk_sweep": [_variant(bp, f"b{i}", carrier_freq=1500 + 0.25 * i)
                       for i in range(3)],
        "qpsk_sweep": [_variant(qp, f"q{i}", carrier_freq=1500 + 0.25 * i)
                       for i in range(2)],
        "mpsk_pair": [mb, _variant(mb, "mb400", agc=replace(
            mb.modem.agc, attack_rate=400.0))],
        "qpsk_gains": [_variant(qp, f"g{k}", pd_gain=k)
                       for k in (32.0, 24.0, 40.0)],
    }


@pytest.mark.parametrize("kind", ["bpsk", "qpsk", "mpsk_bpsk"])
def test_host_params_match_jax(kind):
    jspec = jbuild_chain_spec(44100.0, LINES[kind])
    tspec = build_chain_spec(44100.0, LINES[kind])
    for a, b in ((tmodems._loop_params_host(tspec.modem),
                  jmodems._loop_params_host(jspec.modem)),
                 (tmodems.build_params(tspec.modem),
                  jmodems.build_params(jspec.modem))):
        # the port drops the f64 detector table; K6 reads pd_error_table
        b = {k: v for k, v in b._asdict().items() if k != "pd_table"}
        assert a._fields == tuple(b)
        for fa, fb in zip(a, b.values()):
            if hasattr(fa, "_fields"):
                fa, fb = tuple(fa), tuple(fb)
            np.testing.assert_array_equal(fa, fb)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", ["bpsk_sweep", "qpsk_sweep", "mpsk_pair"])
def test_group_chains_matches_convert(name):
    chains = _banks(44100.0)[name]
    jbanks = jbank.group_chains(chains, jnp.float32)
    tbanks = tbank.group_chains(chains, "cpu")
    assert len(jbanks) == len(tbanks) == 1
    jb, tb = jbanks[0], tbanks[0]
    assert (tb.kind, tb.trim, tb.up, tb.trim_post) == \
        (jb.kind, jb.trim, jb.up, jb.trim_post)
    want = _flat(bank_params_from_jax(jb.params, device="cpu"))
    got = _flat(tb.params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert ("pre_shared" in tb.params) == (name != "mpsk_pair")
    assert torch.equal(got["cos_table/"],
                       torch.from_numpy(tloops.nco_cos_table()))
    if name != "bpsk_sweep":
        assert got["pd_error_table/"].shape == (len(chains), G * G)
        assert torch.equal(got["pd_error_table/"][0], torch.from_numpy(
            tloops.pd_error_table(G, PD_GAIN)))
    # the JAX package's geometry inputs: the slicer window and capacity
    static = jbank._slicer_static(jb)
    assert tbank.slicer_window(tb) == static["compact_window"]
    plan = tbank.default_block_plan(44100 * 20, tb.trim, 44100.0, 4.0, 2.0)
    assert tbank.bank_capacity(tb, plan) == jbank.bank_capacity(jb, plan)
    assert tbank._protocol_max_packet_seconds(chains[0]) == \
        jbank._protocol_max_packet_seconds(chains[0])


def test_gain_sweep_is_one_bank_with_a_table_per_gain():
    """Detector gains differ in no modem leaf: one pre-shared bank whose K6
    lanes read three tables, where the JAX package runs the chains
    unshared (its f64 pd_table is a modem leaf).  Packets agree end to end
    (test_run_banked_matches_jax)."""
    chains = _banks(44100.0, build_chain_spec)["qpsk_gains"]
    (tb,) = tbank.group_chains(chains, "cpu")
    (jb,) = jbank.group_chains(_banks(44100.0)["qpsk_gains"], jnp.float32)
    assert "pre_shared" in tb.params and "pre_shared" not in jb.params
    want = np.stack([tloops.pd_error_table(G, k) for k in (32.0, 24.0, 40.0)])
    assert torch.equal(tb.params["pd_error_table"], torch.from_numpy(want))
    # chains of another granularity go to a bank of their own
    other = _variant(chains[0], "g16", pd_granularity=16)
    assert len(tbank.group_chains(chains + [other], "cpu")) == 2


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

# the QPSK and BPSK sweeps at 8 kHz; the mpsk BPSK-1200 preset needs more
# samples per symbol than 8 kHz gives to decode without RS corrections
E2E_RATES = {"bpsk_sweep": 8000.0, "qpsk_sweep": 8000.0,
             "mpsk_pair": 16000.0, "qpsk_gains": 8000.0}
GEOM = dict(block_seconds=1.5, overlap_seconds=1.5)


def _packets(by_name):
    return {
        name: [(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
                int(p.streamaddress), int(p.bytes_corrected)) for p in pkts]
        for name, pkts in by_name.items()
    }


_CASES: dict = {}


def _e2e_case(name):
    """(JAX chains, port chains, payloads sent, int16 audio) of bank
    ``name``; with the port's run_banked per codec route, each run once in
    this module."""
    if name not in _CASES:
        rate = E2E_RATES[name]
        port_chains = _banks(rate, build_chain_spec)[name]
        rng = np.random.default_rng(20261016)
        sent, x = tfx.synthesize_for_chain(port_chains[0], rate, rng,
                                           n_frames=3, size=10, gap_bits=600)
        _CASES[name] = (_banks(rate)[name], port_chains, sent,
                        tmod.to_int16(x), {})
    return _CASES[name]


def _port_run(name, codec):
    _, port_chains, _, x, runs = _e2e_case(name)
    if codec not in runs:
        runs[codec] = tbank.run_banked(port_chains, x, codec=codec,
                                       device="cpu", **GEOM)
    return runs[codec]


@pytest.mark.parametrize("name", sorted(E2E_RATES))
def test_run_banked_matches_jax(name):
    chains, port_chains, sent, x, _ = _e2e_case(name)
    want = jbank.run_banked(chains, x, dtype=jnp.float32, codec="host",
                            **GEOM)
    got = _port_run(name, "host")
    assert _packets(got) == _packets(want)
    for chain in port_chains:  # every chain decodes every frame, cleanly
        pkts = got[chain.name]
        assert [bytes(p.data[16:-2]) for p in pkts] == sent
        assert all(p.bytes_corrected == 0 for p in pkts)


@pytest.mark.parametrize("name", sorted(E2E_RATES))
def test_device_codec_matches_jax_and_host(name):
    """The device IL2P codec route (the default): packets equal the JAX
    package's device route and the port's host route."""
    chains, port_chains, sent, x, _ = _e2e_case(name)
    want = jbank.run_banked(chains, x, dtype=jnp.float32, codec="device",
                            **GEOM)
    got = _port_run(name, "device")
    assert _packets(got) == _packets(want)
    assert _packets(got) == _packets(_port_run(name, "host"))
    for chain in port_chains:
        assert [bytes(p.data[16:-2]) for p in got[chain.name]] == sent
