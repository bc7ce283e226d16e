"""The readings that a cell's check limits are set from, at the cell's own
size, on the card:

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed: the cell's recordings, one batch of the port's timed path
and the check's sampled lanes; then the check itself (``harness.judge``)
twice against the reference decode of those lanes: once with the port's
packets and reports (the lower readings), once with the control in the
port's place (``reference/arith.py``'s ``control``, the step below the
configuration's float32; the upper readings), each with the ``correct``
that its numbers give at the cell's limits; and a third side, the
reference run in float32 (not the check's: a second witness of where a
float32 decode's stream addresses lie).  Prints one JSON line a seed.
The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace


def in_port_place(s: SimpleNamespace, lanes_out: dict) -> SimpleNamespace:
    """The sample with a reference decode of its lanes put in the port's
    place: its packets per chain and the reports the aggregate gives them."""
    from portbench.reference import compare

    port = [[] for _ in s.chains]
    for (c, _), packets in lanes_out.items():
        port[c].extend((d, a, 0) for d, a in packets)
    reports = compare.reports(s.lines, s.chains, port, s.rate)
    return SimpleNamespace(**{**vars(s), "port": port, "reports": reports})


def readings(bench: dict, name: str, seed: int, device: str = "cuda",
             root=None) -> dict:
    from portbench import harness, loadgen

    cell = harness.Cell(bench, name, root or harness.ROOT)
    recordings, _ = loadgen.recordings(cell.config, cell.mix, seed)
    entry_mod = harness.load_module(cell.entry_file)
    entry = entry_mod.Entry(cell.config, cell.mix, recordings, device)
    idx = list(range(int(cell.mix.get("batch", len(recordings)))))
    job = (0, entry.run(idx)[0])
    s = harness.sample(cell, recordings, job, seed, type(entry))
    s.lines = cell.config["lines"]
    del entry, job
    ref = harness.reference_lanes(cell, s)
    sides = {"port": s}
    for precision in ("control", "float32"):
        sides[precision] = in_port_place(
            s, harness.reference_lanes(cell, s, precision))
    out = {"seed": seed, "lanes": len(s.lanes)}
    for side, sm in sides.items():
        values = harness.readings(cell, sm, ref)
        checks = {k: {"value": v, "limit": cell.limits[k]}
                  for k, v in values.items() if k in cell.limits}
        out[side] = {"correct": harness.passes(checks), **values}
    out["limits"] = {k: v for k, v in cell.limits.items() if k != "lanes"}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench import harness

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(bench, args.workload, seed)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
