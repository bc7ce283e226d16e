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


def _line(name: str, modem: str, preset: str, slicer: str, options: dict,
          poly: str, slicer_options: dict | None = None) -> dict:
    return {"object_name": name, "object_type": "demod_chain",
            "modem": {"type": modem, "config": preset, "options": options},
            "slicer": {"type": slicer, "config": preset,
                       "options": slicer_options or {}},
            "stream": {"type": "lfsr",
                       "options": {"poly": poly, "invert": "no"}},
            "codec": {"type": "il2p", "options": {"crc": "yes"}}}


def qpsk2400_sweep(chains: int = 8) -> dict:
    """A configuration of another family, built in the tests only: upstream
    ``configs/qpsk_2400.json``'s chain (``mpsk`` and the quadrature slicer,
    preset ``qpsk_2400``, IL2P+CRC, poly 0x1) sweeping its carrier over
    +-25 Hz at 44.1 kHz, with a QPSK transmitter on 1500 Hz."""
    step = 50.0 / max(chains - 1, 1)
    lines = [_line(f"QPSK 2400 Il2Pc c{i:02d}", "mpsk", "qpsk_2400",
                   "quadrature", {"carrier_freq": str(1475.0 + step * i)},
                   "0x1") for i in range(chains)]
    return {"sample_rate": 44100,
            "transmitter": {"modulation": "qpsk", "symbol_rate": 1200.0,
                            "carrier_freq": 1500.0, "codec": "il2p",
                            "poly": "0x1", "invert": False, "lead_bits": 240,
                            "tail_bits": 32},
            "lines": lines + [{"object_name": "Raw", "object_type": "report",
                               "options": {"style": "raw"}}]}


def fsk4_sweep(chains: int = 8) -> dict:
    """The 4FSK chain (``fsk`` preset 4800 with the four-level slicer,
    IL2P+CRC) sweeping the slicer's lock rate at 48 kHz: geometry only."""
    lines = [_line(f"4FSK 9600 Il2Pc l{i}", "fsk", "4800", "4level", {},
                   "0x1", {"lock_rate": str(0.975 + 0.002 * i)})
             for i in range(chains)]
    return {"sample_rate": 48000, "lines": lines}


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
