"""The port's multi-recording entry points against pymodem_tpu on the CPU.

``run_banked_many``, ``run_plan_banked_many``, ``run_plans_banked_pipelined``
(two configs in one queue) and ``run_banked_files`` (three files of
different lengths, both codec routes, a coherent bank and an AX.25 bank):
packets (payload, CRC, stream address, corrections) and report text equal
to the JAX package's counterparts on the same synthesized audio, float32,
the same explicit block geometry on both sides; the pipelined entry points
also equal the port's own per-recording runs.  At float64 (the parity
mode, by argument and by ``PYMODEM_TPU_TORCH_X64``) each of the four
entry points equals the JAX package's at x64.  The port runs its kernels'
plain twins here.
"""

import copy
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymodem_tpu.config import build_chain_spec as jbuild_chain_spec
from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu_torch.config import (
    ReportSpec,
    RunPlan,
    build_chain_spec,
)
from pymodem_tpu_torch.mode import X64_VAR
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

RATE = 8000
GEOM = dict(block_seconds=1.0, overlap_seconds=1.0)
REPORTS = (ReportSpec("decoded", style="decoded_headers"),
           ReportSpec("raw", style="raw"))


def _line(name, modem, preset, poly, invert, codec):
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": modem, "config": preset, "options": {}},
        "slicer": {"type": "binary", "config": preset, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": poly,
                                               "invert": invert}},
        "codec": {"type": codec, "options": {"crc": "yes"}},
    }


LINES = {"bpsk": _line("BPSK 1200 Il2Pc", "bpsk", "1200", "0x3", "no",
                       "il2p"),
         "ax25": _line("AFSK 1200 AX25", "afsk", "1200", "0x3", "yes",
                       "ax25")}


def _variant(spec, name, **modem):
    return replace(spec, name=name, modem=replace(spec.modem, **modem),
                   codec=replace(spec.codec, ident=name))


def _chains(build):
    """(config A: a pre-shared 2-chain BPSK-1200 carrier sweep, the
    coherent family whose AGC normal spans the dispatched blocks; config
    B: a 2-chain AFSK-1200 AX.25 space-gain sweep, a correlator bank),
    built by either package's ``build_chain_spec``."""
    bp = build(float(RATE), LINES["bpsk"])
    ax = build(float(RATE), LINES["ax25"])
    return ([_variant(bp, f"b{i}", carrier_freq=1500.0 + 0.25 * i)
             for i in range(2)],
            [_variant(ax, f"a{i}", space_gain=1.0 - 0.1 * i)
             for i in range(2)])


A, B = _chains(build_chain_spec)
JA, JB = _chains(jbuild_chain_spec)


def _synth(chain, seed, n_frames):
    rng = np.random.default_rng(seed)
    sent, x = tfx.synthesize_for_chain(chain, float(RATE), rng,
                                       n_frames=n_frames, size=12,
                                       gap_bits=300)
    return sent, tmod.to_int16(x)


# config A's recordings: two of one length, a shorter third; config B's one
RECORDINGS = [_synth(A[0], 20261101 + i, n) for i, n in enumerate((2, 2, 1))]
AX25_REC = _synth(B[0], 20261111, 2)
# three files of different lengths, each a BPSK part then an AX.25 part
FILES = [(sa + sb, np.concatenate([xa, xb])) for (sa, xa), (sb, xb) in zip(
    (_synth(A[0], 20261121 + i, n) for i, n in enumerate((2, 1, 3))),
    (_synth(B[0], 20261131 + i, n) for i, n in enumerate((1, 2, 1))))]


def _packets(by_name):
    return {
        name: [(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
                int(p.streamaddress), int(p.bytes_corrected)) for p in pkts]
        for name, pkts in by_name.items()
    }


def _jax_plan(plan):
    """The plan with the JAX package's chain specs of the same lines."""
    jax_chains = {c.name: c for c in JA + JB}
    return replace(plan, chains=tuple(jax_chains[c.name]
                                      for c in plan.chains))


_SOLO: dict = {}


def _solo(chains_key, i):
    """The port's run_banked of one recording, run once per module; each
    call gets a copy (the aggregate marks the packets it correlates)."""
    key = (chains_key, i)
    if key not in _SOLO:
        chains, x = ((A, RECORDINGS[i][1]) if chains_key == "A"
                     else (B, AX25_REC[1]))
        _SOLO[key] = tbank.run_banked(chains, x, device="cpu", **GEOM)
    return copy.deepcopy(_SOLO[key])


def test_run_banked_many_matches_jax_and_solo():
    audios = [x for _, x in RECORDINGS]
    got = tbank.run_banked_many(A, audios, depth=1, device="cpu", **GEOM)
    want = jbank.run_banked_many(JA, audios, depth=1, dtype=jnp.float32,
                                 **GEOM)
    assert len(got) == len(want) == len(audios)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _packets(g) == _packets(w), i
        assert _packets(g) == _packets(_solo("A", i)), i
        for chain in A:  # every chain decodes every frame
            assert [bytes(p.data[16:-2]) for p in g[chain.name]] == \
                RECORDINGS[i][0]


def test_run_plan_banked_many_matches_jax():
    plan = RunPlan(chains=tuple(A), reports=REPORTS)
    audios = [x for _, x in RECORDINGS]
    got = tbank.run_plan_banked_many(plan, audios, RATE, depth=2,
                                     resilient=False, device="cpu", **GEOM)
    want = jbank.run_plan_banked_many(_jax_plan(plan), audios, RATE, depth=2,
                                      dtype=jnp.float32, resilient=False,
                                      **GEOM)
    assert [r.reports for r in got] == [r.reports for r in want]
    for i, r in enumerate(got):
        assert r.reports == tbank._finish_plan(plan, _solo("A", i),
                                               RATE).reports
        assert (f"Unique, valid packets:  {len(RECORDINGS[i][0])}\n"
                in r.reports[0])


def test_run_plans_banked_pipelined_two_configs():
    """A queue mixing two configs: reports equal the JAX package's
    pipelined run and the port's per-job run_plan_banked."""
    plan_a = RunPlan(chains=tuple(A), reports=REPORTS)
    plan_b = RunPlan(chains=tuple(B), reports=REPORTS[:1])
    jobs = [(plan_a, RECORDINGS[0][1], RATE), (plan_b, AX25_REC[1], RATE),
            (plan_a, RECORDINGS[2][1], RATE)]
    got = tbank.run_plans_banked_pipelined(jobs, depth=1, device="cpu",
                                           **GEOM)
    want = jbank.run_plans_banked_pipelined(
        [(_jax_plan(p), x, r) for p, x, r in jobs], depth=1,
        dtype=jnp.float32, **GEOM)
    assert [r.reports for r in got] == [r.reports for r in want]
    solo = [_solo("A", 0), _solo("B", 0), _solo("A", 2)]
    for (plan, _, rate), r, by_name in zip(jobs, got, solo):
        assert r.reports == tbank._finish_plan(plan, by_name, rate).reports
    sent = (RECORDINGS[0][0], AX25_REC[0], RECORDINGS[2][0])
    for r, s in zip(got, sent):
        assert f"Unique, valid packets:  {len(s)}\n" in r.reports[0]


_JAX_FILES: dict = {}


def _jax_files(codec):
    """The JAX package's run_banked_files of FILES on ``codec``'s route,
    run once per module."""
    if codec not in _JAX_FILES:
        _JAX_FILES[codec] = jbank.run_banked_files(
            [JA[0], JB[0]], [x for _, x in FILES], dtype=jnp.float32,
            codec=codec, **GEOM)
    return copy.deepcopy(_JAX_FILES[codec])


@pytest.mark.parametrize("codec", ["device", "host"])
def test_run_banked_files_matches_jax(codec):
    """Three files of different lengths through one dispatch per bank (a
    coherent BPSK bank and an AX.25 correlator bank): packets equal the
    JAX package's batched run on the same route, every file decoding every
    frame; the correlator bank's equal each file's solo run_banked too (the
    coherent bank's AGC normal spans the stacked files, as in JAX, so it
    is held to JAX's batched output only)."""
    chains = [A[0], B[0]]
    audios = [x for _, x in FILES]
    got = tbank.run_banked_files(chains, audios, codec=codec, device="cpu",
                                 **GEOM)
    want = _jax_files(codec)
    assert len(got) == len(want) == len(FILES)
    for fi, (g, w) in enumerate(zip(got, want)):
        assert _packets(g) == _packets(w), fi
        decoded = sorted(bytes(p.data[16:-2]) for pkts in g.values()
                         for p in pkts)
        assert decoded == sorted(FILES[fi][0]), fi
        solo = tbank.run_banked([B[0]], audios[fi], codec=codec,
                                device="cpu", **GEOM)
        assert _packets(solo)[B[0].name] == _packets(g)[B[0].name], fi


def test_run_banked_files_coherent_bank_in_one_pass(monkeypatch):
    """A group budget that puts every block in a group of its own: the
    coherent BPSK bank still runs all files' stacked blocks in one pass
    (its AGC normal over every file's frames, as the JAX package's single
    call takes it), the AX.25 correlator bank one block a pass; packets
    still equal the JAX package's batched run."""
    monkeypatch.setattr(tbank, "_GROUP_BUDGET_BYTES", 1)
    passes = {}
    compute = tbank._compute_groups

    def spy(bank, frames, per_group, *args):
        passes[bank.kind] = (frames.shape[0], per_group)
        return compute(bank, frames, per_group, *args)

    monkeypatch.setattr(tbank, "_compute_groups", spy)
    got = tbank.run_banked_files([A[0], B[0]], [x for _, x in FILES],
                                 device="cpu", **GEOM)
    n_bpsk, n_afsk = passes["bpsk"][0], passes["afsk"][0]
    assert passes == {"bpsk": (n_bpsk, n_bpsk), "afsk": (n_afsk, 1)}
    assert n_afsk > 1
    for fi, (g, w) in enumerate(zip(got, _jax_files("device"))):
        assert _packets(g) == _packets(w), fi


# ---------------------------------------------------------------------------
# float64, the parity mode
# ---------------------------------------------------------------------------


def _every_frame(by_name, sent, chains):
    for chain in chains:
        assert [bytes(p.data[16:-2]) for p in by_name[chain.name]] == sent


def test_run_banked_many_f64_matches_jax():
    """run_banked_many at ``dtype=float64`` over two recordings: packets
    equal to the JAX package's at x64, every chain every frame."""
    audios = [x for _, x in RECORDINGS[:2]]
    got = tbank.run_banked_many(A, audios, depth=1, device="cpu",
                                dtype=torch.float64, **GEOM)
    want = jbank.run_banked_many(JA, audios, depth=1, dtype=jnp.float64,
                                 **GEOM)
    assert [_packets(g) for g in got] == [_packets(w) for w in want]
    for g, (sent, _) in zip(got, RECORDINGS):
        _every_frame(g, sent, A)


def test_run_plan_banked_many_f64_by_the_mode_matches_jax(monkeypatch):
    """run_plan_banked_many under PYMODEM_TPU_TORCH_X64 (dtype None):
    reports equal to the JAX package's at x64."""
    monkeypatch.setenv(X64_VAR, "1")
    plan = RunPlan(chains=tuple(A), reports=REPORTS)
    audios = [x for _, x in RECORDINGS[:2]]
    got = tbank.run_plan_banked_many(plan, audios, RATE, depth=2,
                                     resilient=False, device="cpu", **GEOM)
    want = jbank.run_plan_banked_many(_jax_plan(plan), audios, RATE, depth=2,
                                      dtype=jnp.float64, resilient=False,
                                      **GEOM)
    assert [r.reports for r in got] == [r.reports for r in want]
    for r, (sent, _) in zip(got, RECORDINGS):
        assert f"Unique, valid packets:  {len(sent)}\n" in r.reports[0]


def test_run_plans_banked_pipelined_f64_matches_jax():
    """run_plans_banked_pipelined at ``dtype=float64`` over two configs:
    reports equal to the JAX package's at x64."""
    plan_a = RunPlan(chains=tuple(A), reports=REPORTS)
    plan_b = RunPlan(chains=tuple(B), reports=REPORTS[:1])
    jobs = [(plan_a, RECORDINGS[0][1], RATE), (plan_b, AX25_REC[1], RATE)]
    got = tbank.run_plans_banked_pipelined(jobs, depth=1, device="cpu",
                                           dtype=torch.float64, **GEOM)
    want = jbank.run_plans_banked_pipelined(
        [(_jax_plan(p), x, r) for p, x, r in jobs], depth=1,
        dtype=jnp.float64, **GEOM)
    assert [r.reports for r in got] == [r.reports for r in want]
    for r, sent in zip(got, (RECORDINGS[0][0], AX25_REC[0])):
        assert f"Unique, valid packets:  {len(sent)}\n" in r.reports[0]


def test_run_banked_files_f64_by_the_mode_matches_jax(monkeypatch):
    """run_banked_files under PYMODEM_TPU_TORCH_X64 (dtype None), a
    coherent BPSK bank and an AX.25 correlator bank over three files:
    packets equal to the JAX package's batched run at x64, every file
    decoding every frame."""
    monkeypatch.setenv(X64_VAR, "1")
    audios = [x for _, x in FILES]
    got = tbank.run_banked_files([A[0], B[0]], audios, device="cpu", **GEOM)
    want = jbank.run_banked_files([JA[0], JB[0]], audios,
                                  dtype=jnp.float64, **GEOM)
    assert [_packets(g) for g in got] == [_packets(w) for w in want]
    for fi, g in enumerate(got):
        decoded = sorted(bytes(p.data[16:-2]) for pkts in g.values()
                         for p in pkts)
        assert decoded == sorted(FILES[fi][0]), fi
