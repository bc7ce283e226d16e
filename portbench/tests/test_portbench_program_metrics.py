"""The per-layer readers of the port's own spans and counters
(``metrics/validate_ms.py``, ``codec_device_ms.py``,
``rs_launches_per_rec.py``, ``host_syncs_per_rec.py``) on a synthetic
trace, with and without the spans they read, and one traced run of the
tiny AX.25 cell on the CPU."""

import json
import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests import tiny_bench
from portbench.tracing import Event
from pymodem_tpu_torch import profiling


def _read(name, ctx):
    return harness.load_module(tiny_bench.SRC / "metrics" / f"{name}.py"
                               ).read(ctx)


def _ctx(ranges=True):
    """Two recordings: a codec step holding an RS decode, which launches
    a kernel (1 us) and a copy (0.5 us); the codec step launches a GEMM
    (2 us) after it; a FIR outside both (4 us).  ``ranges`` False: the
    same launches without the port's ranges (a parent's trace)."""
    host = [Event("cudaLaunchKernel", 30, 31, corr=1, thread=7),
            Event("cudaMemcpyAsync", 40, 41, corr=2, thread=7),
            Event("cudaLaunchKernel", 70, 71, corr=3, thread=7),
            Event("cudaLaunchKernel", 150, 151, corr=4, thread=7)]
    if ranges:
        host += [Event("pymodem.device_codec_step", 0, 100, thread=7),
                 Event("pymodem.rs_decode", 20, 60, thread=7)]
    dev = [Event("rs_syndromes", 200, 1200, linked=1),
           Event("Memcpy DtoD (Device -> Device)", 1300, 1800, linked=2),
           Event("sm90_gemm", 2000, 4000, linked=3),
           Event("sm90_gemm", 5000, 9000, linked=4)]
    stages = {"aggregate_validate": 0.5} if ranges else {}
    return SimpleNamespace(dev=dev, host=host, stages=stages, n_recs=2)


@pytest.fixture
def counted():
    """Set the port's counters for a reader, and clear them after."""
    def set_counts(**counts):
        profiling.reset()
        profiling.enable(True)
        for name, n in counts.items():
            profiling.count(name, n)
        profiling.enable(False)
    yield set_counts
    profiling.reset()


@pytest.mark.parametrize("name,want", [
    ("validate_ms", 250.0),
    ("codec_device_ms", 3.5e-3 / 2),  # the kernel, the copy and the GEMM
    ("rs_launches_per_rec", 0.5),  # the kernel, not the copy
])
def test_a_reader_reads_its_span(name, want):
    assert _read(name, _ctx()) == pytest.approx(want)
    assert _read(name, _ctx(ranges=False)) is None


def test_host_syncs_read_the_counter(counted):
    counted(host_wait=6, codec_budget_hit=2)
    assert _read("host_syncs_per_rec", _ctx()) == 3.0
    counted(codec_budget_hit=2)
    assert _read("host_syncs_per_rec", _ctx()) is None


def test_a_traced_cpu_run_reports_the_program_metrics(tmp_path):
    """The tiny cell cut to 1.5 s recordings in 0.75 s blocks: the
    profiler keeps every operation of the twins' loops over time (a
    minute and 5 GB here)."""
    bench = tiny_bench.build(tmp_path)
    for path, cut in (("traffic/tiny.json", {"seconds": 1.5}),
                      ("configs/tiny_ax25.json", {"entry": {
                          "block_seconds": 0.75, "overlap_seconds": 0.5}})):
        path = tmp_path / "pb" / path
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **cut)))
    out = harness.run_cell(bench, tiny_bench.AX25, 2**33 + 7, 0.1, True,
                           time.perf_counter(), device="cpu", root=tmp_path)
    metrics = out["metrics"]
    assert metrics["validate_ms"]["value"] > 0
    assert metrics["host_syncs_per_rec"]["value"] >= 1
    # the device's readers find no device operation on the CPU
    assert "codec_device_ms" not in metrics
    assert "rs_launches_per_rec" not in metrics
