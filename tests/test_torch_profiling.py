"""The port's tracing (``profiling``) on the CPU, over the pipelined plan
runner: nothing while disabled; while enabled, ``pymodem.*`` ranges on
the profiler's clock (the aggregate's inside ``finish_plan``, the RS
decode, the collector's pauses), a ``host_wait`` for every blocking
readback, the budget cache's hits and misses, and a report that lists
the counters.  One frame of dense AFSK-1200 IL2P traffic, the device
codec's test fixture, a few bytes long, so each run takes under a
second."""

import gc
from types import SimpleNamespace

import pytest
import torch
from torch.autograd.profiler import profile, record_function

from pymodem_tpu_torch import profiling
from pymodem_tpu_torch.config import ReportSpec, RunPlan
from pymodem_tpu_torch.runtime import bank as tbank
from test_torch_device_codec import KW, RATE, _audio, _chain

PLAN = RunPlan(chains=(_chain(),), reports=(ReportSpec("raw", style="raw"),))
AGGREGATE = ("pymodem.aggregate_validate", "pymodem.aggregate_correlate",
             "pymodem.aggregate_reports")


def _run(audio):
    return tbank.run_plans_banked_pipelined([(PLAN, audio, RATE)], **KW)


def _events(prof):
    """(name, start ns, end ns, thread) of the ranges traced: the port's
    and the fixture's."""
    out = []
    for e in prof.kineto_results.events():
        name = e.name()
        if name.startswith(("pymodem.", "test.")):
            out.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.start_thread_id()))
    return out


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread: the twins' loops run one lane, where the
    thread pool only adds to a step's cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(one_thread):
    """One session of torch.autograd's profiler (torch.profiler's first
    start imports for seconds), whose stop time grows with the operations
    traced: a run with tracing off over the frame's first 800 samples,
    then one with it on over the whole frame, cold (the budget cache
    empty).  Then a warm run, not profiled."""
    _, audio = _audio(20261018, 1, 4, 8)
    profiling.reset()
    with profile() as prof:
        with record_function("test.off"):
            off = _run(audio[:800])
        off_stats = (profiling.stages(), profiling.counts())
        tbank._CODEC_BUDGET_CACHE.clear()
        profiling.enable(True)
        try:
            cold = _run(audio)
            gc.collect()
            cold_counts, report = profiling.counts(), profiling.report()
            hooked = profiling._gc_hook in gc.callbacks
        finally:
            profiling.enable(False)
    profiling.reset()
    profiling.enable(True)
    try:
        warm = _run(audio)
        warm_counts = profiling.counts()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert len(off) == 1
    assert [len(r[0].aggregate.unique) for r in (cold, warm)] == [1, 1]
    cold_bytes = sum(len(p.data) for chain in cold[0].aggregate.chains
                     for p in chain)
    return SimpleNamespace(events=_events(prof), off_stats=off_stats,
                           cold=cold_counts, warm=warm_counts, report=report,
                           hooked=hooked, cold_bytes=cold_bytes)


def _spans(runs, name):
    return [e for e in runs.events if e[0] == name]


def test_tracing_off_leaves_no_range_and_no_stage(runs):
    (_, lo, hi, _), = _spans(runs, "test.off")
    assert not [e for e in runs.events
                if e[0].startswith("pymodem.") and lo <= e[1] <= hi]
    assert runs.off_stats == ({}, {})
    assert profiling._gc_hook not in gc.callbacks


def test_aggregate_spans_nest_in_finish_plan(runs):
    (finish,) = _spans(runs, "pymodem.finish_plan")
    (collect,) = _spans(runs, "pymodem.plan_collect")
    assert len(_spans(runs, "pymodem.plan_submit")) == 1
    assert collect[1] <= finish[1] <= finish[2] <= collect[2]
    assert collect[3] == finish[3]
    for name in AGGREGATE:
        (e,) = _spans(runs, name)
        assert finish[1] <= e[1] <= e[2] <= finish[2], name
        assert e[3] == finish[3], name


def test_an_il2p_plan_shows_rs_decode(runs):
    assert _spans(runs, "pymodem.rs_decode")
    assert runs.cold["rs_decode"] >= 1


def test_collections_are_ranges_while_enabled(runs):
    assert runs.hooked
    assert _spans(runs, "pymodem.gc")
    assert runs.cold["gc"] >= 1


def test_host_waits_count_the_syncs(runs):
    """Warm, the cached budgets leave one packed readback per codec
    sub-group (one here); cold, the sizing readbacks come first."""
    assert runs.warm["codec_budget_hit"] == 1
    assert "codec_budget_miss" not in runs.warm
    assert runs.warm["host_wait"] == 1
    assert runs.cold["codec_budget_miss"] == 1
    assert runs.cold["host_wait"] > runs.warm["host_wait"]
    assert runs.cold["aggregate_packets"] >= runs.cold["aggregate_valid"] >= 1


def test_report_lists_the_counters(runs):
    stages, counters = runs.report.split("counters:")
    assert "finish_plan" in stages and "host_wait" in stages
    for name in ("aggregate_packets", "aggregate_valid", "codec_budget_miss"):
        assert name in counters
    assert "host_wait" not in counters


def test_the_crc_byte_count_covers_every_packet(runs):
    """``aggregate_crc_bytes``: the bytes of every packet the traced run's
    batched validation covered, listed among the report's counters."""
    assert runs.cold["aggregate_crc_bytes"] == runs.cold_bytes > 0
    assert "aggregate_crc_bytes" in runs.report.split("counters:")[1]
