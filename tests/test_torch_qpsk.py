"""The Costas QPSK family of the port against pymodem_tpu: kernel K5's plain
twin, bank parameters, and packets end to end.

Method, as for K3 (tests/test_torch_psk.py).  The twin rounds every
multiply and add on its own, in the JAX op order, as K5 does (built with
-fmad=false).  ``_reference`` is the same loop in plain numpy f32 with a
chosen set of multiply-adds fused into one rounding; the twin equals the
reference with nothing fused, bitwise, and XLA-CPU's output equals the
reference with the sites XLA fuses, bitwise:

* the Pallas kernel ``_iq_loop_kernel`` kind ``qpsk`` in interpret mode (17
  rows with the AGC, 12 without): the NCO phase update, and on both branch
  IIRs ``(b0*m + b0*m_prev) + a1*y_prev`` the first product with the
  second and the sum with the third (``fma(a1, y_prev, fma(b0, m,
  b0*m_prev))``);
* the ``qpsk_costas`` scan at ``unroll=1`` after the AGC scan: the same,
  except that the sine branch fuses its second product instead
  (``fma(b0, m_prev, b0*m)``).

The loop IIR and the PI sites leave these inputs' outputs unchanged whether
fused or not (every combination was tried); the reference fuses the PI
integral, as XLA does for K3.  On a host without FMA XLA fuses nothing and
its output equals the unfused reference.  The twin reads XLA's own
``sin``/``cos`` of the 256 quantised angles here; kernel and twin read
``nco_sine_table``/``nco_cos_table`` on the card.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pymodem_tpu import modems as jmodems
from pymodem_tpu.config import (
    ChainSpec as JChainSpec,
    IL2PCodecSpec as JIL2PCodecSpec,
    LFSRStreamSpec as JLFSRStreamSpec,
    QuadratureSlicerSpec as JQuadratureSlicerSpec,
    _qpsk_preset as j_qpsk_preset,
)
from pymodem_tpu.dsp import window_design as jwd
from pymodem_tpu.dsp.agc import agc_apply as jagc
from pymodem_tpu.dsp.loops import (
    TWO_PI,
    LoopParams,
    QPSKLoopParams,
    qpsk_costas as jqpsk,
)
from pymodem_tpu.dsp.pallas_loops import (
    agc_lane_params as jagc_rows,
    iq_loop_lanes_pallas,
    lane_params_from_loop as jloop_rows,
)
from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu_torch import modems as tmodems
from pymodem_tpu_torch.config import (
    ChainSpec,
    IL2PCodecSpec,
    LFSRStreamSpec,
    QuadratureSlicerSpec,
    _qpsk_preset,
)
from pymodem_tpu_torch.convert import bank_params_from_jax
from pymodem_tpu_torch.dsp import loops as tloops
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

RATE = 8000.0
C, B, T = 2, 3, 1500
AGC_FIELDS = ("scaled_attack", "scaled_decay", "sustain_time",
              "sustain_increment", "target")
# fused sites: (cosine branch IIR, sine branch IIR) forms, and the rest
PALLAS_FUSED = ("a", "a", frozenset({"phase", "int"}))
SCAN_FUSED = ("a", "b", frozenset({"phase", "int"}))


def _fma(a, b, c):
    """f32 a*b + c rounded once (the f64 sum of an exact f32 product,
    rounded to f32: differs from a true fma only on an f32 tie)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _xla_tables():
    angle = np.arange(256, dtype=np.float32) * np.float32(TWO_PI / 256)
    return (np.array(jnp.sin(jnp.asarray(angle))),
            np.array(jnp.cos(jnp.asarray(angle))))


def _case(rng):
    """Noisy QPSK at 1200 Bd on the chains' carriers (1800 + 3 i Hz) at
    8 kHz, the preset "2400" loops and AGC: the loop locks as on the decode
    path."""
    specs = [replace(j_qpsk_preset("2400", RATE), carrier_freq=1800.0 + 3 * i)
             for i in range(C)]
    k = (np.arange(T) / (RATE / 1200.0)).astype(int)
    s_i = (rng.integers(0, 2, (C, B, k[-1] + 1)) * 2 - 1)[..., k]
    s_q = (rng.integers(0, 2, (C, B, k[-1] + 1)) * 2 - 1)[..., k]
    w = (2 * np.pi * (1801.0 + 3 * np.arange(C)[:, None, None])
         * np.arange(T) / RATE + rng.uniform(0, 6, (C, B, 1)))
    x = (1.5 * (s_i * np.cos(w) - s_q * np.sin(w))
         + 0.2 * rng.standard_normal((C, B, T))).astype(np.float32)
    loops = [jmodems._loop_params_host(s) for s in specs]
    loop = {k_: np.stack([np.asarray(getattr(lp, k_), np.float32)
                          for lp in loops]) for k_ in LoopParams._fields}
    branch = np.array([jwd.iir1_lpf_coefs(s.sample_rate, s.branch_lpf_cutoff,
                                          1.0) for s in specs], np.float32)
    agcs = [jmodems._agc_params(s.agc, s.sample_rate) for s in specs]
    agc = {k_: np.array([getattr(a, k_) for a in agcs], np.float32)
           for k_ in AGC_FIELDS}
    normals = x.reshape(C, -1).max(axis=1)
    rows = np.concatenate([
        np.asarray(jloop_rows(LoopParams(**loop), C, B)),
        np.repeat(branch.T, B, axis=1),
        np.asarray(jagc_rows(type("A", (), agc), jnp.asarray(normals), C, B)),
    ]).astype(np.float32)
    return x, loop, branch, agc, normals, rows


def _iir(m, m_prev, y_prev, b0, a1, form):
    """(b0*m + b0*m_prev) + a1*y_prev: ``form`` "" rounds each step, "a"
    fuses b0*m into the first sum, "b" fuses b0*m_prev; both fused forms
    fuse a1*y_prev into the second."""
    if not form:
        return (b0 * m + b0 * m_prev) + a1 * y_prev
    first = (_fma(b0, m, b0 * m_prev) if form == "a"
             else _fma(b0, m_prev, b0 * m))
    return _fma(a1, y_prev, first)


def _reference(x, rows, sine, cosine, fused=("", "", frozenset())):
    """The f32 Costas QPSK loop over (L, T) lanes in numpy, op by op as the
    twin (the AGC first when ``rows`` has 17 rows), with the multiply-adds
    that ``fused`` names fused at every step."""
    cos_form, sin_form, sites = fused
    (ps, sf, isc, b0, a1, gp, gain, pi_i, lim, i0, bb0, ba1) = rows[:12]
    zero = np.zeros(x.shape[0], np.float32)
    phase = control = e_prev = y_prev = env = sustain = zero
    cos_x = cos_y = sin_x = sin_y = zero
    integral = i0
    two_pi = np.float32(TWO_PI)
    out_i, out_q = np.empty_like(x), np.empty_like(x)
    for t in range(x.shape[1]):
        x_t = x[:, t]
        if len(rows) == 17:
            att, dec, sus_t, sus_inc, target = rows[12:]
            rising = np.abs(x_t) > env
            env = np.where(rising, np.minimum(env + att, np.abs(x_t)), env)
            sustain = np.where(rising, zero, sustain)
            env = np.where(sustain >= sus_t, np.maximum(env - dec, zero), env)
            sustain = sustain + sus_inc
            with np.errstate(divide="ignore", invalid="ignore"):
                x_t = np.where(env != 0, target * x_t / env, x_t)
        step = sf + control
        p = _fma(ps, step, phase) if "phase" in sites else phase + ps * step
        for _ in range(2):
            p = np.where(p >= two_pi, p - two_pi, p)
        for _ in range(2):
            p = np.where(p < 0, p + two_pi, p)
        phase = p
        idx = (p * isc).astype(np.int32) & 255
        i_mixer = x_t * cosine[idx]
        cos_out = _iir(i_mixer, cos_x, cos_y, bb0, ba1, cos_form)
        q_mixer = x_t * sine[idx]
        sin_out = _iir(q_mixer, sin_x, sin_y, bb0, ba1, sin_form)
        one = np.float32(1.0)
        e = (cos_out * np.where(sin_out >= 0, one, -one)
             - sin_out * np.where(cos_out >= 0, one, -one))
        y = (b0 * e + b0 * e_prev) + a1 * y_prev
        if "int" in sites:
            acc = _fma(gain, pi_i * y, integral)
        else:
            acc = integral + gain * (pi_i * y)
        integral = np.minimum(np.maximum(acc, -lim), lim)
        control = gp * y + integral
        out_i[:, t], out_q[:, t] = sin_out, cos_out
        e_prev, y_prev = e, y
        cos_x, cos_y, sin_x, sin_y = i_mixer, cos_out, q_mixer, sin_out
    return out_i, out_q


def _assert_fused(want, reference, fused):
    """``want`` (XLA-CPU) is ``reference(fused)`` bitwise -- or, on a host
    without FMA, the unfused reference."""
    plain = reference(("", "", frozenset()))
    if all(np.array_equal(w, p) for w, p in zip(want, plain)):
        return
    for w, g in zip(want, reference(fused)):
        np.testing.assert_array_equal(w, g)


def _twin(x, rows, sine, cosine):
    return tuple(v.numpy() for v in tloops.qpsk_costas_lanes(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(rows)),
        torch.from_numpy(sine), torch.from_numpy(cosine)))


@pytest.mark.parametrize("n_rows", [17, 12], ids=["agc_fused", "loop_only"])
def test_qpsk_twin_matches_pallas_kernel(rng, n_rows):
    x, _, _, _, _, rows = _case(rng)
    rows = rows[:n_rows]
    xl = x.reshape(C * B, T)
    sine, cosine = _xla_tables()
    got = _twin(xl, rows, sine, cosine)
    for g, w in zip(got, _reference(xl, rows, sine, cosine)):
        np.testing.assert_array_equal(g, w)
    want = tuple(np.asarray(v) for v in iq_loop_lanes_pallas(
        jnp.asarray(xl), jnp.asarray(rows), "qpsk", wavetable_size=256,
        tc=256))
    _assert_fused(want, lambda f: _reference(xl, rows, sine, cosine, f),
                  PALLAS_FUSED)


def test_qpsk_twin_matches_agc_then_costas_scan(rng):
    x, loop, branch, agc, normals, rows = _case(rng)
    want_i, want_q = np.empty_like(x), np.empty_like(x)
    for c in range(C):
        lp = QPSKLoopParams(
            base=LoopParams(**{k: jnp.asarray(v[c]) for k, v in loop.items()}),
            branch_b0=jnp.asarray(branch[c, 0]),
            branch_a1=jnp.asarray(branch[c, 1]))
        for b in range(B):
            y = jagc(jnp.asarray(x[c, b]), agc["scaled_attack"][c],
                     agc["scaled_decay"][c], agc["sustain_time"][c],
                     agc["sustain_increment"][c], agc["target"][c],
                     unroll=4, normal=jnp.asarray(normals[c]))
            want_i[c, b], want_q[c, b] = (np.asarray(v) for v in
                                          jqpsk(y, lp, unroll=1))
    xl = x.reshape(C * B, T)
    sine, cosine = _xla_tables()
    _assert_fused((want_i.reshape(C * B, T), want_q.reshape(C * B, T)),
                  lambda f: _reference(xl, rows, sine, cosine, f),
                  SCAN_FUSED)
    # the twin on the port's own tables: the unfused reference, bitwise
    s, c_ = tloops.nco_sine_table(), tloops.nco_cos_table()
    for g, w in zip(_twin(xl, rows, s, c_), _reference(xl, rows, s, c_)):
        np.testing.assert_array_equal(g, w)


def test_qpsk_wrapper_refuses_other_row_counts():
    x = torch.zeros(2, 8)
    tabs = (torch.zeros(256), torch.zeros(256))
    with pytest.raises(ValueError, match="17"):
        tloops.qpsk_costas_lanes(x, torch.zeros(15, 2), *tabs)


@pytest.mark.parametrize("n_rows", [17, 12], ids=["agc_fused", "loop_only"])
def test_qpsk_shared_rows_equal_copied_rows(rng, n_rows):
    """K5's lanes on B shared rows through ``row_of_lane`` (a pre-shared
    bank: lane c*B + b reads row b) give, bitwise, what they give on the
    C*B rows copied out."""
    x, _, _, _, _, rows = _case(rng)
    shared = torch.from_numpy(x[0])  # (B, T): every chain reads chain 0's
    row_of_lane = torch.arange(B, dtype=torch.int32).repeat(C)
    lp = torch.from_numpy(np.ascontiguousarray(rows[:n_rows]))
    tabs = (torch.from_numpy(tloops.nco_sine_table()),
            torch.from_numpy(tloops.nco_cos_table()))
    got = tloops.qpsk_costas_lanes(shared, lp, *tabs, row_of_lane)
    want = tloops.qpsk_costas_lanes(shared.repeat(C, 1), lp, *tabs)
    for g, w in zip(got, want):
        assert g.shape == (C * B, T)
        assert torch.equal(g, w)


def test_qpsk_wrapper_refuses_bad_row_of_lane():
    """``row_of_lane`` must be (L,) int32 inside the R input rows."""
    x = torch.zeros(3, 8)
    lp = torch.zeros(17, 6)
    tabs = (torch.zeros(256), torch.zeros(256))
    ok = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32)
    for bad, what in ((ok.long(), "int32"), (ok[:5], "int32"),
                      (ok - 1, "outside"), (ok + 1, "outside")):
        with pytest.raises(ValueError, match=what):
            tloops.qpsk_costas_lanes(x, lp, *tabs, bad)
    with pytest.raises(ValueError, match="bad shapes"):  # R != L, no map
        tloops.qpsk_costas_lanes(x, lp, *tabs)


# ---------------------------------------------------------------------------
# Host parameters, bank parameters, end to end
# ---------------------------------------------------------------------------


def _chain(rate, build=ChainSpec, preset=_qpsk_preset,
           slicer=QuadratureSlicerSpec, stream=LFSRStreamSpec,
           codec=IL2PCodecSpec, name="qc"):
    """bench.py's Costas-QPSK chain (``_family_workload``): preset "2400",
    quadrature slicer 1200 Bd / lock 0.9 / 2 bits / mask 0xF, poly 0x1."""
    return build(
        name=name, modem=preset("2400", rate),
        slicer=slicer(sample_rate=rate, symbol_rate=1200.0, lock_rate=0.9,
                      bits_per_symbol=2, state_mask=0xF),
        stream=stream(polynomial=0x1, invert=False), codec=codec(ident=name))


def _jchain(rate, name="qc"):
    return _chain(rate, JChainSpec, j_qpsk_preset, JQuadratureSlicerSpec,
                  JLFSRStreamSpec, JIL2PCodecSpec, name)


def _variant(spec, name, **modem):
    return replace(spec, name=name, modem=replace(spec.modem, **modem),
                   codec=replace(spec.codec, ident=name))


def _banks(rate, chain=_jchain):
    """A pre-shared carrier sweep (bench.py's step, 0.25 Hz) and a pair the
    AGC attack keeps apart (not shared)."""
    base = chain(rate)
    return {
        "sweep": [_variant(base, f"q{i}", carrier_freq=1800.0 + 0.25 * i)
                  for i in range(3)],
        "pair": [base, _variant(base, "qa400", agc=replace(
            base.modem.agc, attack_rate=400.0))],
    }


@pytest.mark.parametrize("preset", ["2400", "3600", "600"])
def test_host_params_match_jax(preset):
    tspec, jspec = _qpsk_preset(preset, 44100.0), j_qpsk_preset(preset, 44100.0)
    for a, b in ((tmodems._loop_params_host(tspec),
                  jmodems._loop_params_host(jspec)),
                 (tmodems.build_params(tspec), jmodems.build_params(jspec))):
        assert a._fields == b._fields
        for fa, fb in zip(a, b):
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


@pytest.mark.parametrize("name", ["sweep", "pair"])
def test_group_chains_matches_convert(name):
    jchains = _banks(44100.0)[name]
    chains = _banks(44100.0, _chain)[name]
    (jb,) = jbank.group_chains(jchains, jnp.float32)
    (tb,) = tbank.group_chains(chains, "cpu")
    assert (tb.kind, tb.trim, tb.up, tb.trim_post) == \
        (jb.kind, jb.trim, jb.up, jb.trim_post)
    want = _flat(bank_params_from_jax(jb.params, device="cpu"))
    got = _flat(tb.params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert ("pre_shared" in tb.params) == (name == "sweep")
    assert got["branch_b0/"].shape == (len(chains),)
    # K5's inputs: the pre-shared sweep's B rows (lane c*B + b on row b),
    # the pair's C*B; lane rows the loop's, the branch IIR's, the AGC's
    frames = torch.zeros(2, 4000)
    x, rows, row_of_lane = tbank.coherent_loop_inputs(tb.params, frames)
    n_chains = len(chains)
    assert rows.shape == (17, 2 * n_chains)
    assert torch.equal(rows[10], tb.params["branch_b0"].repeat_interleave(2))
    assert row_of_lane.dtype == torch.int32
    if name == "sweep":
        assert x.shape[0] == 2
        assert row_of_lane.tolist() == [0, 1] * n_chains
    else:
        assert x.shape[0] == 2 * n_chains
        assert row_of_lane.tolist() == list(range(2 * n_chains))
    static = jbank._slicer_static(jb)
    assert tbank.slicer_window(tb) == static["compact_window"]
    plan = tbank.default_block_plan(44100 * 20, tb.trim, 44100.0, 4.0, 2.0)
    assert tbank.bank_capacity(tb, plan) == jbank.bank_capacity(jb, plan)
    assert tbank.bank_auto_geometry(tb, 44100.0, 0.2)[1] == \
        jbank.bank_auto_geometry(jb, 44100.0, jnp.float32, 0.2)[1]


def _packets(by_name):
    return {
        name: [(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
                int(p.streamaddress), int(p.bytes_corrected)) for p in pkts]
        for name, pkts in by_name.items()
    }


GEOM = dict(block_seconds=1.5, overlap_seconds=1.5)
_CASES: dict = {}


def _e2e_case(name):
    """(JAX chains, port chains, payloads sent, int16 audio) of bank
    ``name``; with the port's run_banked per codec route, each run once in
    this module."""
    if name not in _CASES:
        port_chains = _banks(RATE, _chain)[name]
        rng = np.random.default_rng(20261016)
        sent, x = tfx.synthesize_for_chain(port_chains[0], RATE, rng,
                                           n_frames=3, size=10, gap_bits=600)
        _CASES[name] = (_banks(RATE)[name], port_chains, sent,
                        tmod.to_int16(x), {})
    return _CASES[name]


def _port_run(name, codec):
    _, port_chains, _, x, runs = _e2e_case(name)
    if codec not in runs:
        runs[codec] = tbank.run_banked(port_chains, x, codec=codec,
                                       device="cpu", **GEOM)
    return runs[codec]


@pytest.mark.parametrize("name", ["sweep", "pair"])
def test_run_banked_matches_jax(name):
    """Every chain decodes every frame with no RS correction, and the
    packets equal the JAX package's (f32, host codec, same geometry)."""
    chains, port_chains, sent, x, _ = _e2e_case(name)
    want = jbank.run_banked(chains, x, dtype=jnp.float32, codec="host",
                            **GEOM)
    got = _port_run(name, "host")
    assert _packets(got) == _packets(want)
    for chain in port_chains:
        pkts = got[chain.name]
        assert [bytes(p.data[16:-2]) for p in pkts] == sent
        assert all(p.bytes_corrected == 0 for p in pkts)


@pytest.mark.parametrize("name", ["sweep", "pair"])
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
