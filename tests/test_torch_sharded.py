"""The port's sharded runtime (``pymodem_tpu_torch/runtime/sharded.py``)
on CPU ranks over gloo.

Ranks are spawned through the port's own launcher, once per mesh shape,
and every case of that shape runs inside the one spawn
(``_torch_sharded_ranks.py``, which imports no JAX); the results come back
to this process.  The dry-run bank on mesh (2, 2) is held packet for
packet against the JAX package's ``run_banked_sharded`` on the conftest's
virtual CPU devices; the time-axis (AGC all-reduce) and chain-axis cases
against the port's ``run_banked`` and the JAX package's ``run_banked`` at
float32 (which the JAX package's own tests hold equal to its sharded run).
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

import _torch_sharded_ranks as ranks
from pymodem_tpu_torch.config import build_chain_spec
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.runtime import sharded
from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod

HERE = os.path.dirname(os.path.abspath(__file__))
RATE = 8000


def _rows(by_name):
    return sharded.packet_rows(by_name)


def _jax_rows(chains, audio, **kw):
    """The JAX package's single-device ``run_banked`` at float32."""
    import jax.numpy as jnp
    from pymodem_tpu.runtime import bank as jbank

    return _rows(jbank.run_banked(chains, audio, dtype=jnp.float32, **kw))


def _beside(ranks_fn, here_fn):
    """(ranks_fn(), here_fn()): the spawned ranks run while this process
    computes its side of the comparison."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(ranks_fn)
        here = here_fn()
        return spawned.result(), here


# ---------------------------------------------------------------------------
# 1. the dry-run bank on mesh (2, 2) against the JAX package
# ---------------------------------------------------------------------------


def _jax_dryrun_case():
    """The dry run's chains and audio from the JAX package's own classes
    and synthesizer (``__graft_entry__.dryrun_multichip``'s)."""
    from pymodem_tpu.config import (
        AFSKModemSpec,
        AX25CodecSpec,
        BinarySlicerSpec,
        ChainSpec,
        IL2PCodecSpec,
        LFSRStreamSpec,
    )
    from pymodem_tpu.synth import fixtures as fx
    from pymodem_tpu.synth import modulate as mod

    rate = 8000.0
    rng = np.random.default_rng(11)
    chains, segments = [], []

    def chain(name, invert, codec):
        return ChainSpec(
            name=name, modem=AFSKModemSpec(sample_rate=rate),
            slicer=BinarySlicerSpec(sample_rate=rate, symbol_rate=1200.0,
                                    lock_rate=0.75),
            stream=LFSRStreamSpec(polynomial=0x3, invert=invert), codec=codec)

    for i, invert in enumerate((False, True)):
        line = fx.il2p_line_bits(fx.payloads(rng, count=3, size=24),
                                 polynomial=0x3, invert=invert, gap_bits=2000)
        segments.append(mod.afsk_modulate(line, rate, 1200.0, 1200.0, 2200.0))
        chains.append(chain(f"dry{i}", invert, IL2PCodecSpec(ident=f"dry{i}")))
    line = fx.ax25_line_bits(fx.payloads(rng, count=3, size=24),
                             polynomial=0x3, invert=False, gap_bits=2000)
    segments.append(mod.afsk_modulate(line, rate, 1200.0, 1200.0, 2200.0))
    chains.append(chain("dryax", False, AX25CodecSpec(ident="dryax")))
    return chains, np.concatenate(segments).astype(np.float32)


@pytest.fixture(scope="module")
def dryrun_2x2():
    """Rank 0's dry run on four CPU ranks (``dryrun_multichip`` asserts
    its own contract on every rank) and the JAX package's sharded run of
    the same bank on a (2, 2) mesh of virtual CPU devices."""
    from pymodem_tpu.runtime.sharded import make_mesh, run_banked_sharded

    chains, audio = _jax_dryrun_case()
    assert np.array_equal(audio, sharded.dryrun_case()[1])
    port, jax_out = _beside(
        lambda: sharded.dryrun_multichip(4, "cpu"),
        lambda: run_banked_sharded(chains, audio, make_mesh(2, 2),
                                   dtype=np.float32, **sharded.DRYRUN_KW))
    return port, _rows(jax_out)


def test_dryrun_mesh_2x2_matches_jax(dryrun_2x2):
    """The mixed IL2P/AX.25 bank, padded to the chain axis, on mesh (2, 2)
    at float32: packet for packet the JAX package's run_banked_sharded."""
    port, want = dryrun_2x2
    assert port["first"] == want
    assert all(len(v) >= 3 for v in want.values())


def test_dryrun_warm_call_counts(dryrun_2x2):
    """The repeat call: one packed gather per codec sub-group, no sizing
    reduction, no block on the host FSM; no pad chain in the result."""
    port, _ = dryrun_2x2
    c = port["counts"]
    assert c.get("sharded_codec_transfer") == 2, c
    assert c.get("host_codec", 0) == 0, c
    assert c.get("sharded_codec_sizing", 0) == 0, c
    assert c.get("sharded_candidate_budget", 0) == 0, c
    assert port["again"] == port["first"]
    assert sorted(port["first"]) == ["dry0", "dry1", "dryax"]


# ---------------------------------------------------------------------------
# 2 and 4. the time axis: the AFSK-PLL pair on mesh (1, 2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def time_axis():
    """tests/_mh_case.py's AFSK-PLL pair (4 blocks x 4 s at 8 kHz) on two
    time shards (one spawn); the port's run_banked of it, the JAX
    package's, and the block plan."""
    sys.path.insert(0, HERE)
    import _mh_case as case

    chains, audio = case.build()
    kw = dict(block_seconds=case.BLOCK_SECONDS,
              overlap_seconds=case.OVERLAP_SECONDS)
    outs, (want, jax_want) = _beside(
        lambda: sharded.spawn(ranks.time_axis, 2, "cpu", chains, audio, kw),
        lambda: (_rows(tbank.run_banked(chains, audio, device="cpu", **kw)),
                 _jax_rows(chains, audio, **kw)))
    plan = tbank.bank_plan(tbank.group_chains(chains, "cpu")[0], len(audio),
                           **kw)
    return outs, want, jax_want, plan


def test_time_axis_matches_run_banked(time_axis):
    """The PLL pair's blocks split over two time shards, the AGC normal a
    MAX all-reduce over them: exactly the port's run_banked."""
    outs, want, _, _ = time_axis
    assert outs[0]["packets"] == want
    assert sum(len(v) for v in want.values()) >= 8  # 4 frames x 2 chains


def test_time_axis_matches_jax(time_axis):
    """The same two time shards against the JAX package's run_banked at
    float32 on the whole recording: each chain's payloads equal, in order,
    and each address within one sample.  Not bitwise: XLA:CPU fuses some
    of the f32 PLL's multiply-adds (test_torch_loops.py, ``SCAN_FUSED``)
    and the port's loop does not, so a lock point can move by a sample;
    on this recording pll1's last packet sits at 100581 in the port and
    at 100582 in the JAX package, with or without sharding."""
    outs, _, jax_want, _ = time_axis
    got = outs[0]["packets"]
    assert sorted(got) == sorted(jax_want)
    for chain, want in jax_want.items():
        assert [d for _, d in got[chain]] == [d for _, d in want]
        assert all(abs(a - b) <= 1
                   for (a, _), (b, _) in zip(got[chain], want))
    assert sum(len(v) for v in jax_want.values()) >= 8


def test_time_axis_ranks_agree_and_normal_is_all_reduced(time_axis):
    """Every rank returns the same packets, and each ran the normal's
    all-reduce (one block group a shard: once) and one gather."""
    outs, _, _, _ = time_axis
    assert [o["rank"] for o in outs] == [0, 1]
    assert outs[1]["packets"] == outs[0]["packets"]
    for o in outs:
        assert o["counts"].get("sharded_agc_normal") == 1, o["counts"]
        assert o["counts"].get("sharded_codec_transfer") == 1, o["counts"]


def test_per_rank_upload_within_bound(time_axis):
    """Each rank uploads only its own blocks' frame rows (the
    ``sharded_upload_samples`` count): blocks per shard x block_input_len
    samples, at most n_audio / n_time + blocks per shard x (overlap +
    trim) + block_len, less than the recording."""
    outs, _, _, plan = time_axis
    b_local = sharded.blocks_per_shard(plan, 2)
    assert b_local == 2 and plan.up == 1
    bound = (plan.n_audio // 2 + b_local * (plan.overlap + plan.trim)
             + plan.block_len)
    for o in outs:
        samples = o["counts"]["sharded_upload_samples"]
        assert samples == b_local * plan.block_input_len
        assert samples <= bound == sharded.upload_bound(plan, 2)
        assert samples < plan.n_audio


# ---------------------------------------------------------------------------
# 3 and 5. the chain axis: a space-gain sweep on mesh (2, 1)
# ---------------------------------------------------------------------------


def _sweep_case(build=build_chain_spec):
    """Three AFSK-300 correlator chains, space gains 1.0, 0.98 and 1.0
    (the ``space_scale`` route; on this clean audio only a unity gain
    decodes), and ~9 s of int16 audio carrying 3 IL2P+CRC frames on
    1600/1800 Hz tones.  On two chain shards the bank is padded to four
    chains: shard 0 holds s0 and s1, shard 1 s2 and a clone of s0.
    ``build``: the port's build_chain_spec, or the JAX package's."""
    from dataclasses import replace

    base = build(float(RATE), {
        "object_name": "AFSK 300 Il2Pc Correlator",
        "object_type": "demod_chain",
        "modem": {"type": "afsk", "config": "300", "options": {}},
        "slicer": {"type": "binary", "config": "300", "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                               "invert": "no"}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}}})
    chains = [replace(base, name=f"s{i}",
                      modem=replace(base.modem, space_gain=gain),
                      codec=replace(base.codec, ident=f"s{i}"))
              for i, gain in enumerate((1.0, 0.98, 1.0))]
    return chains, _afsk300_audio(count=3, size=10)


def _afsk300_audio(count, size, n=None):
    """int16 AFSK-300 audio on 1600/1800 Hz tones carrying ``count``
    IL2P+CRC frames of ``size``-byte payloads, zero-padded to ``n``
    samples."""
    rng = np.random.default_rng(20261016)
    line = tfx.il2p_line_bits(tfx.payloads(rng, count=count, size=size),
                              polynomial=0x3, gap_bits=400)
    x = tmod.to_int16(tmod.afsk_modulate(line, float(RATE), 300.0, 1600.0,
                                         1800.0))
    return x if n is None else np.pad(x, (0, n - len(x)))


def _dense_case():
    """12 IL2P frames of 24 bytes, 200 idle bits apart, at 1200 Bd and 8
    kHz: ~6 frames a 3.5 s block window (chip_smoke.py's forced-escalation
    traffic)."""
    from pymodem_tpu_torch.config import (
        AFSKModemSpec,
        BinarySlicerSpec,
        ChainSpec,
        IL2PCodecSpec,
        LFSRStreamSpec,
    )

    rng = np.random.default_rng(20261016)
    sent = tfx.payloads(rng, count=12, size=24)
    line = tfx.il2p_line_bits(sent, polynomial=0x3, gap_bits=200)
    chain = ChainSpec(
        name="dense", modem=AFSKModemSpec(sample_rate=float(RATE)),
        slicer=BinarySlicerSpec(sample_rate=float(RATE), symbol_rate=1200.0,
                                lock_rate=0.75),
        stream=LFSRStreamSpec(polynomial=0x3, invert=False),
        codec=IL2PCodecSpec(ident="dense"))
    audio = tmod.afsk_modulate(line, float(RATE), 1200.0, 1200.0, 2200.0)
    return chain, sent, np.asarray(audio, np.float32)


# budgets too small for the dense traffic: 2 packet slots a block and 8
# candidate slots, fixed, so some blocks stay dropped at MP_CAP
FORCED = dict(max_packets_per_block=2, total_candidates=8,
              block_seconds=2.0, overlap_seconds=1.5)


@pytest.fixture(scope="module")
def chain_axis():
    chains, audio = _sweep_case()
    grown = _afsk300_audio(count=2, size=50, n=len(audio))
    dense, sent, dense_audio = _dense_case()
    kw = dict(block_seconds=2.0, overlap_seconds=2.5)

    def here():
        from pymodem_tpu.config import build_chain_spec as jax_build

        want = {codec: _rows(tbank.run_banked(chains, audio, codec=codec,
                                              device="cpu", **kw))
                for codec in ("device", "host")}
        want["redo"] = _rows(tbank.run_banked(chains, grown, device="cpu",
                                              **kw))
        jax_chains = _sweep_case(jax_build)[0]
        want["jax"] = _jax_rows(jax_chains, audio, **kw)
        want["jax_redo"] = _jax_rows(jax_chains, grown, **kw)
        want["forced"] = _rows(tbank.run_banked([dense], dense_audio,
                                                device="cpu", **FORCED))
        return want

    outs, want = _beside(
        lambda: sharded.spawn(ranks.chain_axis, 2, "cpu", chains, audio,
                              grown, kw, dense, dense_audio, FORCED), here)
    assert "space_scale" in tbank.group_chains(chains, "cpu")[0].params
    return outs, want, sent


def test_chain_axis_matches_run_banked(chain_axis):
    """Each chain shard demods its own chains of the sweep (the scale
    ratios taken to the shard's first chain): the port's run_banked on
    both ranks."""
    outs, want, _ = chain_axis
    assert outs[0]["device"] == outs[1]["device"] == want["device"]
    assert {k: len(v) for k, v in want["device"].items()} == \
        {"s0": 3, "s1": 0, "s2": 3}


def test_chain_axis_matches_jax(chain_axis):
    """The sweep on two chain shards, and the longer packets of the redo
    case on the budgets it cached: packet for packet the JAX package's
    run_banked at float32."""
    outs, want, _ = chain_axis
    for o in outs:
        assert o["device"] == want["jax"]
        assert o["redo"] == want["jax_redo"]
    assert sum(len(v) for v in want["jax"].values()) == 6


def test_host_codec_matches_run_banked(chain_axis):
    """``codec="host"`` on the chain-axis mesh: every rank gathers the
    byte streams and runs the exact state machines, equal to run_banked's
    host route."""
    outs, want, _ = chain_axis
    assert outs[0]["host"] == outs[1]["host"] == want["host"]
    assert want["host"] == want["device"]


def test_cached_budgets_overflow_redoes_the_compaction(chain_axis):
    """A recording of the same length with longer packets, on the budgets
    the first call cached: the packed buffers overflow their byte rows, so
    the compaction is redone at the gathered sizes on both ranks, and the
    packets equal run_banked's."""
    outs, want, _ = chain_axis
    for o in outs:
        assert o["redo_counts"].get("sharded_codec_redo") == 1, \
            o["redo_counts"]
        assert o["redo_counts"].get("sharded_codec_sizing", 0) == 0
        assert o["redo"] == want["redo"]
    assert {k: len(v) for k, v in want["redo"].items()} == \
        {"s0": 2, "s1": 0, "s2": 2}


def test_small_budgets_escalate_then_fall_back(chain_axis):
    """Dense traffic on 2 packet slots a block and 8 candidate slots: the
    shards escalate on the device up to MP_CAP, then decode the blocks
    still dropped on the host FSM from the gathered byte streams; every
    frame, equal to run_banked's on the same budgets."""
    outs, want, sent = chain_axis
    for o in outs:
        c = o["forced_counts"]
        assert c.get("sharded_codec_escalate", 0) == 5, c  # 2 -> MP_CAP
        assert c.get("host_codec", 0) >= 1, c
        assert o["forced"] == want["forced"]
    assert sorted(d[16:-2] for _, d in want["forced"]["dense"]) == \
        sorted(sent)


# ---------------------------------------------------------------------------
# 6. failure, and the parts that need no ranks
# ---------------------------------------------------------------------------


def test_dying_rank_fails_spawn():
    """A rank that raises makes spawn raise in the caller with its
    traceback, well within the group's timeout, and leaves no rank
    running."""
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*on "
                                           "purpose"):
        sharded.spawn(ranks.fail_on_rank, 2, "cpu", 1)
    assert time.time() - t0 < sharded.TIMEOUT.total_seconds() / 2


def test_make_mesh_cuda_needs_a_gpu(monkeypatch):
    """The mesh and the launcher default to CUDA and raise without a GPU;
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sharded.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sharded.spawn(ranks.fail_on_rank, 1)


@pytest.mark.parametrize("n_time", [1, 2, 3])
def test_frame_blocks_host_rows_are_frame_blocks(n_time):
    """Shard t's rows are rows [t*b, (t+1)*b) of ``bank.frame_blocks`` of
    the whole recording, then all-zero rows up to a multiple of the time
    axis."""
    rng = np.random.default_rng(n_time)
    audio = rng.integers(-2000, 2000, 23_456).astype(np.int16)
    plan = tbank.BlockPlan(len(audio), trim=37, block_len=3000,
                           overlap=1700)
    want = tbank.frame_blocks(torch.from_numpy(audio), plan).numpy()
    got = np.concatenate([sharded.frame_blocks_host(audio, plan, n_time, t)
                          for t in range(n_time)])
    assert got.dtype == np.int16
    assert np.array_equal(got[:plan.n_blocks], want)
    assert not got[plan.n_blocks:].any()
    assert len(got) == -(-plan.n_blocks // n_time) * n_time


def test_reorder_pad_bank_and_chain_shards():
    """The dry-run bank's two codec sub-groups become contiguous and
    padded to the chain axis with a clone under a ``__pad`` name; each
    chain shard takes its half of each, parameters cut with the chains."""
    chains, _ = sharded.dryrun_case()
    bank = tbank.group_chains(chains, "cpu")[0]
    padded, slices = sharded._reorder_pad_bank(
        bank, 2, tbank._codec_subgroups(bank))
    assert [s.name for s in padded.specs] == ["dry0", "dry1", "dryax",
                                              "__pad0~dryax"]
    assert [(lo, hi) for _, lo, hi in slices] == [(0, 2), (2, 4)]
    assert padded.stream_inverts == (False, True, False, False)
    mine, local = sharded._shard_chains(slices, 2, 1)
    assert mine == [1, 3]
    assert [(a, b) for *_, a, b in local] == [(0, 1), (1, 2)]
    sub = tbank.bank_chain_slice(padded, mine)
    for key in ("sps", "space_scale"):
        assert torch.equal(sub.params[key], bank.params[key][[1, 2]])
    assert torch.equal(sub.params["modem"]["mark_i"],
                       bank.params["modem"]["mark_i"][[1, 2]])
