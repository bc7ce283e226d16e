"""Whole runs of the harness: on the CPU over the port's plain twins at a
tiny size (the check for a chip skipped), with the timed path broken
underneath, and on the card."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.tests import tiny_bench

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    return root, tiny_bench.build(root)


def _run(tiny, cell, trace=False):
    root, bench = tiny
    return harness.run_cell(bench, cell, 2**33 + 5, 0.1, trace,
                            time.perf_counter(), device="cpu", root=root)


def _break(result, fault):
    """A fault planted where the runner's result is produced."""
    chains = result.aggregate.chains
    if fault == "drop_half":
        # half of the batch's chains left out
        for packets in chains[: len(chains) // 2]:
            packets.clear()
    elif fault == "alter":
        # a byte of every packet altered
        for packets in chains:
            for p in packets:
                p.data = list(p.data)
                p.data[len(p.data) // 2] ^= 0x01
    return result


@pytest.fixture
def broken(monkeypatch):
    """Plant a fault under the entry kind's ``run``, as the window calls
    it, or in the port's aggregate."""
    def plant(fault):
        if fault == "aggregate":
            from pymodem_tpu_torch.packets import PacketAggregate

            # the cross-chain dedup window taken as 0: no correlation
            correlate = PacketAggregate.correlate
            monkeypatch.setattr(PacketAggregate, "correlate",
                                lambda self, address_distance:
                                correlate(self, 0.0))
            return
        load = harness.load_module

        def load_broken(path):
            mod = load(path)
            if path.parent.name == "entries":
                base = mod.Entry

                class Entry(base):
                    def run(self, indices):
                        return [_break(r, fault)
                                for r in base.run(self, indices)]
                mod.Entry = Entry
            return mod
        monkeypatch.setattr(harness, "load_module", load_broken)
    return plant


def test_result_keys_and_a_correct_run(tiny):
    out = _run(tiny, tiny_bench.AX25)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"chain_msps", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == {"packet_mismatch_pct", "address_moved_pct",
                                  "report_mismatch"}
    json.dumps(out)


@pytest.mark.parametrize("fault", ["drop_half", "alter", "aggregate"])
def test_a_broken_timed_path_is_not_correct(tiny, fault, broken):
    broken(fault)
    out = _run(tiny, tiny_bench.AX25)
    assert out["correct"] is False, out["checks"]


def test_a_pll_cell_runs_correct(tiny):
    out = _run(tiny, tiny_bench.PLL)
    assert out["correct"] is True, out["checks"]


def test_refuses_a_directory_without_the_port(tmp_path):
    shutil.copy(tiny_bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny_bench.SRC, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "afsk1200_ax25_sweep8.busy_10min", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert run.returncode != 0
    assert run.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "afsk1200_ax25_sweep8.busy_10min", "--seed", str(2**33 + 9),
         "--seconds", "2", "--trace", "1"], cwd=tiny_bench.ROOT,
        capture_output=True, text=True, timeout=360)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", [tiny_bench.AX25, tiny_bench.PLL])
def test_the_control_in_the_port_place_is_not_correct(tiny, cell):
    """``control.py``'s readings go through the check's own comparison:
    the port reads correct, the control (the step below float32) put in
    its place does not."""
    from portbench import control

    root, bench = tiny
    out = control.readings(bench, cell, 2**33 + 5, device="cpu", root=root)
    assert out["port"]["correct"] is True, out
    assert out["control"]["correct"] is False, out
