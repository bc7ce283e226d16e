"""A benchmark root with two tiny cells, built in a temporary folder from
new files only (configurations, a mix, limits) beside copies of the
benchmark's entry kinds and metric readers: what a later change adds for a
new cell, without editing a file of the benchmark."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

SRC = Path(__file__).resolve().parents[1]
ROOT = SRC.parent
PLL = "tiny_pll.tiny"
AX25 = "tiny_ax25.tiny"


def build(root: Path) -> dict:
    """Write the tiny benchmark under ``root``; returns its BENCHMARK.json."""
    pb = root / "pb"
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    for d in ("entries", "metrics"):
        shutil.copytree(SRC / d, pb / d, dirs_exist_ok=True)
    pll = json.loads((SRC / "configs/afsk300_pll_sweep64.json").read_text())
    pll["lines"] = pll["lines"][:2] + pll["lines"][-1:]
    pll["entry"] = {"block_seconds": 4.0, "overlap_seconds": 3.0}
    ax = json.loads((SRC / "configs/afsk1200_ax25_sweep8.json").read_text())
    ax["sample_rate"] = 8000
    ax["lines"] = ax["lines"][:2] + ax["lines"][-1:]
    ax["entry"] = {"block_seconds": 3.0, "overlap_seconds": 1.5}
    for name, cfg in (("tiny_pll", pll), ("tiny_ax25", ax)):
        (pb / f"configs/{name}.json").write_text(json.dumps(cfg))
    mix = {"entry": "pipelined_plans", "depth": 1, "batch": 2,
           "recordings": 2, "seconds": 10, "snr_db": [12, 24],
           "snr_bandwidth_hz": 3000,
           "frames": {"il2p": {"arrivals": "back_to_back", "gap_bits": 200,
                               "payload_bytes": [20, 30], "cycle": 2},
                      "ax25": {"arrivals": "load", "load": 0.5,
                               "payload_bytes": [20, 40], "cycle": 4}}}
    (pb / "traffic/tiny.json").write_text(json.dumps(mix))
    for cell in (PLL, AX25):
        src = ("afsk300_pll_sweep64.quiet_hour" if cell == PLL
               else "afsk1200_ax25_sweep8.busy_10min")
        lim = json.loads((SRC / f"limits/{src}.json").read_text())
        lim["lanes"] = 4
        (pb / f"limits/{cell}.json").write_text(json.dumps(lim))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["paths"] = ["pb"]
    bench["configs"] = [
        {"name": n, "source": "https://github.com/ninocarrillo/pymodem",
         "file": f"pb/configs/{n}.json", "reduced": [], "why": "test"}
        for n in ("tiny_pll", "tiny_ax25")]
    bench["workloads"] = [
        {"name": c, "config": c.split(".")[0], "traffic": "tiny", "chips": 1,
         "why": "test"} for c in (PLL, AX25)]
    for m in bench["per_layer"]:
        m["workloads"] = [PLL, AX25]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench
