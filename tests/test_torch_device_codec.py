"""The port's device-codec route of ``run_banked`` (budgets, escalation,
host fallback, budget cache, codec sub-groups) on the CPU.

Dense AFSK-1200 IL2P traffic at 8 kHz, as tests/test_bank_runtime.py's
device-codec tests build it.  Every route must give the same packets
(payload and stream address) as a roomy run and as the host route
(``codec="host"``, the reference-exact state machines): bitwise.  Parity
of the device route with the JAX package's is held in
tests/test_torch_{bank,psk,fsk,qpsk}.py.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from pymodem_tpu_torch import profiling
from pymodem_tpu_torch.config import (
    AFSKModemSpec,
    BinarySlicerSpec,
    ChainSpec,
    IL2PCodecSpec,
    LFSRStreamSpec,
)
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.synth import fixtures as fx
from pymodem_tpu_torch.synth import modulate as mod

RATE = 8000.0
KW = dict(device="cpu", block_seconds=2.0, overlap_seconds=1.5)


def _chain(name="dense", **codec):
    return ChainSpec(
        name=name,
        modem=AFSKModemSpec(sample_rate=RATE),
        slicer=BinarySlicerSpec(sample_rate=RATE, symbol_rate=1200.0,
                                lock_rate=0.75),
        stream=LFSRStreamSpec(polynomial=0x3, invert=False),
        codec=IL2PCodecSpec(ident=name, **codec),
    )


def _audio(seed, count, size, gap_bits):
    rng = np.random.default_rng(seed)
    sent = fx.payloads(rng, count=count, size=size)
    line = fx.il2p_line_bits(sent, polynomial=0x3, invert=False,
                             gap_bits=gap_bits)
    return sent, np.asarray(mod.afsk_modulate(line, RATE, 1200.0, 1200.0,
                                              2200.0), np.float32)


def _pkts(res):
    return {name: [(int(p.streamaddress), bytes(p.data)) for p in pkts]
            for name, pkts in res.items()}


def _counted(fn):
    """(fn(), profiling counts of that call)."""
    profiling.reset()
    profiling.enable(True)
    try:
        out = fn()
        return out, profiling.counts()
    finally:
        profiling.enable(False)
        profiling.reset()


@pytest.fixture(scope="module")
def dense():
    """12 frames, ~6 in each 3.5 s block window; the roomy device run, and
    the host route on the same audio."""
    sent, audio = _audio(20261018, 12, 24, 200)
    chain = _chain()
    tbank._CODEC_BUDGET_CACHE.clear()
    roomy = tbank.run_banked([chain], audio, max_packets_per_block=16,
                             total_candidates=4096, **KW)
    host = tbank.run_banked([chain], audio, codec="host", **KW)
    assert _pkts(roomy) == _pkts(host)
    assert [p.data[16:-2] for p in roomy["dense"]] == [list(s) for s in sent]
    return chain, audio, _pkts(roomy)


def test_auto_sizing_needs_no_escalation(dense):
    """The sizing readback right-sizes the packet slots from the busiest
    block's candidates: a tight default needs no escalation."""
    chain, audio, roomy = dense
    tbank._CODEC_BUDGET_CACHE.clear()
    tight, counts = _counted(lambda: tbank.run_banked(
        [chain], audio, max_packets_per_block=2, **KW))
    assert counts.get("device_codec_escalate", 0) == 0, counts
    assert counts.get("candidate_budget", 0) == 1, counts
    assert _pkts(tight) == roomy


def test_forced_escalation_recovers_every_packet(dense):
    """An explicit candidate budget skips the sizing readback, so 2 packet
    slots a block saturate and the escalation ladder (slots x2, codec
    re-run) must recover every packet on the device."""
    chain, audio, roomy = dense
    tbank._CODEC_BUDGET_CACHE.clear()
    forced, counts = _counted(lambda: tbank.run_banked(
        [chain], audio, max_packets_per_block=2, total_candidates=64, **KW))
    assert counts.get("device_codec_escalate", 0) >= 1, counts
    assert counts.get("packet_fallback_blocks", 0) == 0, counts
    assert _pkts(forced) == roomy


def test_host_fallback_recovers_every_packet(dense):
    """8 candidate slots for the whole recording stay 8 up the ladder (an
    explicit budget does not double), so blocks stay dropped past MP_CAP
    and decode on the host state machines: the same packets."""
    chain, audio, roomy = dense
    tbank._CODEC_BUDGET_CACHE.clear()
    res, counts = _counted(lambda: tbank.run_banked(
        [chain], audio, max_packets_per_block=2, total_candidates=8, **KW))
    assert counts.get("packet_fallback_blocks", 0) >= 1, counts
    assert counts.get("packet_fallback", 0) == 1, counts
    assert counts.get("device_codec_escalate", 0) == 5, counts  # 2 -> 64
    assert _pkts(res) == roomy


def test_warm_call_reads_back_once(dense):
    """A second call of the same shape takes the cached budgets: no sizing
    readbacks, one packed readback, the same packets."""
    chain, audio, roomy = dense
    tbank._CODEC_BUDGET_CACHE.clear()
    first = tbank.run_banked([chain], audio, **KW)
    assert len(tbank._CODEC_BUDGET_CACHE) == 1
    warm, counts = _counted(lambda: tbank.run_banked([chain], audio, **KW))
    assert counts.get("candidate_budget", 0) == 0, counts
    assert counts.get("codec_sizes", 0) == 0, counts
    assert counts.get("device_codec_transfer", 0) == 1, counts
    assert _pkts(first) == _pkts(warm) == roomy


def test_merge_budget_entry_keeps_upper_bounds():
    """Entries are (packet slots, candidates, scan cap, metadata slots, row
    width, RS split fraction, payload budget): the merge keeps each upper
    bound, and None (no budget, no split) wins over a number."""
    a = (8, 96, 16, 64, 96, 2, 192)
    b = (16, 64, 8, 128, 64, None, 1023)
    assert tbank._merge_budget_entry(None, a) == a
    assert tbank._merge_budget_entry(a, b) == (16, 96, 16, 128, 96, None,
                                               1023)
    assert tbank._merge_budget_entry(a, a[:5] + (4, 192))[5] == 2
    assert tbank._merge_budget_entry(a[:1] + (None,) + a[2:], a)[1] is None


def test_budget_cache_merges_heterogeneous_workloads():
    """A long-packet recording escalates the payload budget to 1023; a
    short-packet one of the same shape shares the cache key.  The entry
    merges upper bounds, so repeat runs of both need no escalation, redo
    or host fallback, and give the same packets (the JAX package's
    heterogeneous case)."""
    chain = _chain("m")
    _, long_rec = _audio(7, 2, 300, 20000)
    _, short_rec = _audio(8, 2, 40, 20000)
    n = max(len(long_rec), len(short_rec))
    long_rec = np.pad(long_rec, (0, n - len(long_rec)))
    short_rec = np.pad(short_rec, (0, n - len(short_rec)))
    kw = dict(KW, block_seconds=8.0)
    tbank._CODEC_BUDGET_CACHE.clear()
    first_long, c1 = _counted(lambda: tbank.run_banked([chain], long_rec,
                                                       **kw))
    assert c1.get("device_codec_escalate", 0) >= 1, c1
    first_short = tbank.run_banked([chain], short_rec, **kw)
    assert len(tbank._CODEC_BUDGET_CACHE) == 1
    entry = next(iter(tbank._CODEC_BUDGET_CACHE.values()))
    assert entry[6] == 1023, entry

    def again():
        return (tbank.run_banked([chain], long_rec, **kw),
                tbank.run_banked([chain], short_rec, **kw))

    (again_long, again_short), counts = _counted(again)
    assert counts.get("device_codec_escalate", 0) == 0, counts
    assert counts.get("device_codec_redo", 0) == 0, counts
    assert counts.get("packet_fallback", 0) == 0, counts
    assert _pkts(again_long) == _pkts(first_long)
    assert _pkts(again_short) == _pkts(first_short)
    assert len(first_long["m"]) == len(first_short["m"]) == 2
    host = tbank.run_banked([chain], long_rec, codec="host", **kw)
    assert _pkts(host) == _pkts(first_long)


def test_mixed_codec_options_split_into_subgroups(dense):
    """Chains that differ only in IL2P options share one demod bank and
    run one device codec per option sub-group, in config order; packets
    equal the host route's."""
    _, audio, _ = dense
    chains = [_chain("crc"), _chain("nocrc", collect_trailing_crc=False),
              _chain("crc2")]
    banks = tbank.group_chains(chains, "cpu")
    assert len(banks) == 1
    groups = tbank._codec_subgroups(banks[0])
    assert [idxs for _, idxs in groups] == [[0, 2], [1]]
    tbank._CODEC_BUDGET_CACHE.clear()
    dev, counts = _counted(lambda: tbank.run_banked(chains, audio, **KW))
    assert counts.get("device_codec_step", 0) == 2, counts
    assert counts.get("host_codec", 0) == 0, counts
    host = tbank.run_banked(chains, audio, codec="host", **KW)
    assert sorted(dev) == sorted(c.name for c in chains)
    assert _pkts(dev) == _pkts(host)
    assert all(len(v) == 12 for v in _pkts(dev).values())


def _no_gc(counts):
    """``counts`` without the collector's pauses, a stage while enabled."""
    return {k: n for k, n in counts.items() if k != "gc"}


def test_profiling_counts_times_and_traces(tmp_path):
    """profiling collects nothing until enabled; then timed() stages and
    count() counters, a report, and a torch.profiler trace file."""
    profiling.reset()
    with profiling.timed("off"):
        profiling.count("off")
    assert profiling.counts() == {} and profiling.report() == ""
    _, counts = _counted(lambda: profiling.count("blocks", 3))
    assert _no_gc(counts) == {"blocks": 3}
    profiling.enable(True)
    try:
        with profiling.trace(str(tmp_path)):
            with profiling.timed("stage"):
                torch.arange(10).sum()
        assert _no_gc(profiling.counts()) == {"stage": 1}
        assert "stage" in profiling.report()
        assert profiling.stages()["stage"] >= 0
    finally:
        profiling.enable(False)
        profiling.reset()
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_codec_argument_is_checked(dense):
    chain, audio, _ = dense
    with pytest.raises(ValueError, match="codec"):
        tbank.run_banked([chain], audio, codec="fast", **KW)
    assert tbank._codec_static_key(replace(chain.codec)) == (
        "il2p", True, False, 0, 0)
