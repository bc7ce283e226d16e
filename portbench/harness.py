"""The benchmark of ``pymodem_tpu_torch``: one run of one cell.

``BENCHMARK.json`` names each cell's configuration (``configs/``) and
traffic mix (``traffic/``); the mix names its entry kind (``entries/``);
the configuration's transmitter names its modulation
(``transmitters/<modulation>.py``) and its chains their reference stages
(``reference/{modems,slicers,streams,codecs}/<kind>.py``); each per-layer
metric is read by ``metrics/<name>.py``; each cell's check limits are
``limits/<cell>.json``.  A new cell, mix, configuration, modem family,
transmitter or metric is new files and new entries, never an edit here.

A run: set-up (torch, the CUDA context, the recordings from the seed, one
warm batch that builds or loads the kernel library and fills the codec's
budget cache), then a closed loop of batches for ``--seconds`` (the window
closes when the batch in flight at that time returns), then the check of
what the window produced against the plain reference (``reference/``).
With ``--trace 1`` the window runs under ``torch.profiler`` with the
benchmark's spans and the port's ``profiling`` stages on, and the result
carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pymodem_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``pymodem_tpu_torch`` is not ``pymodem_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Cell:
    """A workload of BENCHMARK.json with its files resolved."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads(
            (root / configs[self.workload["config"]]["file"]).read_text())
        bench_dir = root / bench["paths"][0]
        self.mix = json.loads(
            (bench_dir / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.entry_file = bench_dir / "entries" / f"{self.mix['entry']}.py"
        self.limits = json.loads(
            (bench_dir / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [(m, bench_dir / "metrics" / f"{m['name']}.py")
                          for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.workload["chips"])


def _roofline_reader(ctx, recordings, completed, chains, device_name):
    from .roofline.peaks import peak

    def share(module):
        ns = sum(e.end - e.start for e in ctx.dev if module.KERNEL in e.name)
        bw = peak(device_name, "hbm_bytes_per_s")
        if not ns or bw is None:
            return None
        need = sum(module.bytes_needed(chains, len(recordings[i]))
                   for i in completed)
        return 100.0 * need / bw / (ns * 1e-9)
    return share


def sample(cell: Cell, recordings: list, job: tuple, seed: int,
           entry_cls) -> SimpleNamespace:
    """What the check compares in ``job`` (recording index, RunResult),
    a job the window drew from the seed: seed-drawn lanes, led by the lane
    of most packets and the lane of the longest packet."""
    from .reference import decode

    config = cell.config
    rate = float(config["sample_rate"])
    kw = {k: v for k, v in config.get("entry", {}).items()
          if k in ("block_seconds", "overlap_seconds", "max_packet_seconds")}
    rng = np.random.default_rng([seed, 0x5EED])
    rec, result = job
    audio = recordings[rec]
    port = entry_cls.chain_packets(result)
    chains = decode.chains_from_lines(config["lines"], rate)
    geo = decode.geometry(chains, len(audio), rate, **kw)
    counts = Counter((c, geo.block_of(a)) for c, pk in enumerate(port)
                     for _, a, _ in pk)
    lanes = []
    if counts:
        lanes.append(max(counts, key=counts.get))
        _, c, a = max((len(d), c, a) for c, pk in enumerate(port)
                      for d, a, _ in pk)
        lanes.append((c, geo.block_of(a)))
    # half of the rest among the lanes the port decoded packets in, half
    # among all lanes (where a port that dropped packets left them)
    want = cell.limits["lanes"]
    busy = sorted(counts)
    for k in rng.permutation(len(busy)):
        if len(set(lanes)) >= (want + len(lanes)) // 2:
            break
        lanes.append(busy[int(k)])
    for k in rng.permutation(len(chains) * geo.n_blocks):
        if len(set(lanes)) >= want:
            break
        lanes.append(divmod(int(k), geo.n_blocks))
    return SimpleNamespace(rec=rec, reports=entry_cls.reports(result),
                           audio=audio, port=port, chains=chains, geo=geo,
                           lanes=list(dict.fromkeys(lanes)), kw=kw, rate=rate)


def reference_lanes(cell: Cell, s: SimpleNamespace,
                    precision: str = "float64") -> dict:
    """The reference decode of the sampled lanes (``reference/decode.py``)."""
    from .reference import decode

    return decode.decode_lanes(cell.config["lines"], s.rate, s.audio,
                               s.lanes, s.kw, precision=precision)


def readings(cell: Cell, s: SimpleNamespace, ref: dict) -> dict:
    """Every number the check can compare: the sampled lanes of
    ``s.port`` against the reference's, and the reports ``s.reports``
    against the aggregate worked out again."""
    from .reference import compare

    counts = compare.lane_mismatch(ref, s.port, s.lanes, s.geo, s.chains, log)
    values = compare.readings(counts)
    values["report_mismatch"] = compare.report_mismatch(
        cell.config["lines"], s.chains, s.port, s.reports, s.rate)
    log(f"check: recording {s.rec}, {len(s.lanes)} lanes, {counts}")
    return values


def judge(cell: Cell, s: SimpleNamespace, ref: dict) -> dict:
    """The numbers the cell's limits file names, each with its limit."""
    return {k: {"value": v, "limit": cell.limits[k]}
            for k, v in readings(cell, s, ref).items() if k in cell.limits}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def check(cell: Cell, recordings: list, job: tuple, seed: int,
          entry_cls) -> dict:
    """The comparison that decides ``correct``, over ``job`` (recording
    index, RunResult), a job the window drew from the seed."""
    s = sample(cell, recordings, job, seed, entry_cls)
    t0 = time.perf_counter()
    ref = reference_lanes(cell, s)
    log(f"reference: {time.perf_counter() - t0:.1f} s")
    return judge(cell, s, ref)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", root: Path = ROOT) -> dict:
    """One run of one cell; returns the result object.  ``device="cpu"``
    (tests only) runs the port's plain twins and skips the card's
    readings."""
    import torch

    from . import loadgen, tracing

    cell = Cell(bench, name, root)
    split = {"import": time.perf_counter() - t0}
    torch.zeros(1, device=device)
    split["context"] = time.perf_counter() - t0 - sum(split.values())
    recordings, sent = loadgen.recordings(cell.config, cell.mix, seed)
    split["synthesis"] = time.perf_counter() - t0 - sum(split.values())
    entry_mod = load_module(cell.entry_file)
    entry = entry_mod.Entry(cell.config, cell.mix, recordings, device)
    n_rec = len(recordings)
    batch = int(cell.mix.get("batch", n_rec))

    def batch_of(k):
        return [(k * batch + j) % n_rec for j in range(batch)]

    entry.run(batch_of(0))
    if device != "cpu":
        torch.cuda.synchronize()
    split["warm"] = time.perf_counter() - t0 - sum(split.values())
    setup_s = time.perf_counter() - t0
    log("setup split (s): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in split.items()))

    # the window keeps the recording index of every completed job, the
    # decode counts of the first of each recording, and one job drawn from
    # the seed for the check (a reservoir of one): holding every RunResult
    # would grow the heap through the window and slow the collector
    completed, first, attempted, failed = [], {}, 0, 0
    draw, kept = np.random.default_rng([seed, 0xD4A3]), None
    spans: dict[str, list] = defaultdict(list)
    # per batch: wall, the main thread's CPU time, the whole process's CPU
    # time and the collector's time (where the wall varies with the main
    # thread's CPU time for the same work, the host's CPU ran slower)
    batches: list[tuple] = []
    gc_s = [0.0, 0.0]

    def gc_timer(phase, _info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]

    def host_clocks():
        return (time.perf_counter(), time.thread_time(), time.process_time(),
                gc_s[0])

    def window():
        nonlocal attempted, failed, kept
        w0, k = time.perf_counter(), 0
        gc.callbacks.append(gc_timer)
        while True:
            idx = batch_of(k)
            attempted += len(idx)
            b0 = host_clocks()
            try:
                results = entry.run(idx)
            except Exception as exc:  # noqa: BLE001 - counted as failed
                failed += len(idx)
                log(f"batch {k} failed: {type(exc).__name__}: {exc}")
                results = []
            for i, res in zip(idx, results):
                completed.append(i)
                first.setdefault(i, (
                    len(res.aggregate.unique),
                    sum(len(c) for c in res.aggregate.chains)))
                if draw.integers(len(completed)) == 0:
                    kept = (i, res)
            del results
            batches.append(tuple(b - a for a, b in zip(b0, host_clocks())))
            k += 1
            if time.perf_counter() - w0 >= seconds:
                break
        gc.callbacks.remove(gc_timer)
        if device != "cpu":
            torch.cuda.synchronize()
        return time.perf_counter() - w0

    prof = None
    if trace:
        from pymodem_tpu_torch import profiling

        profiling.reset()
        profiling.enable()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with entry.spans(lambda n, s: spans[n].append(s)):
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("portbench.window"):
                    window_s = window()
        profiling.enable(False)
        stages = profiling.stages()
    else:
        window_s = window()
    n_chains = len(entry.plan.chains)
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in range(cell.chips)) if device != "cpu" else 0
    kind = (torch.cuda.get_device_name(0) if device != "cpu" else "cpu")
    dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                "kind": kind, "count": cell.chips,
                "memory_peak_bytes": int(peak)}
    chain_samples = sum(n_chains * len(recordings[i]) for i in completed)
    log(f"decode: {sent} frames sent in {n_rec} recordings; unique packets "
        f"per recording {[first[i][0] for i in sorted(first)]}; packets per "
        f"chain {[first[i][1] / n_chains for i in sorted(first)]}")
    for i, what in enumerate(("walls", "main thread CPU", "process CPU",
                              "collector")):
        log(f"batch {what} (s): " + " ".join(f"{b[i]:.3f}" for b in batches))
    log(f"window: {len(completed)} recordings in {window_s:.3f} s, "
        f"{attempted} attempted, {failed} failed")

    metrics, breakdown = {}, None
    if trace:
        dev, host, span = tracing.events(prof, "portbench.window")
        fir = tracing.launched_within(dev, host, "portbench.fir")

        def ms(ops):
            return sum(e.end - e.start for e in ops) * 1e-6

        def gemm(ops):
            return [e for e in ops if "gemm" in e.name.lower()]

        log(f"trace: {len(dev)} device operations; under the FIR spans "
            f"{len(fir)} ({ms(fir):.3f} ms), of them GEMMs "
            f"{len(gemm(fir))} ({ms(gemm(fir)):.3f} ms); GEMMs in all "
            f"{len(gemm(dev))} ({ms(gemm(dev)):.3f} ms)")
        from .reference.decode import chains_from_lines

        chains = chains_from_lines(cell.config["lines"],
                                   cell.config["sample_rate"])
        ctx = SimpleNamespace(dev=dev, host=host, spans=spans, stages=stages,
                              n_recs=len(completed), window_s=span.seconds,
                              busy_s=tracing.busy_seconds(dev))
        ctx.roofline = _roofline_reader(ctx, recordings, completed, chains,
                                        kind)
        for m, path in cell.per_layer:
            value = load_module(path).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = ctx.busy_s
        dev_info["window_s"] = ctx.window_s
        breakdown = {"device_ops": tracing.top_ops(dev),
                     "idle_gaps": tracing.idle_gaps(dev, host, span)}
        del prof, dev, host
    else:
        values = {"chain_msps": chain_samples / window_s / 1e6,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    entry_cls = type(entry)
    del entry
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    checks = (check(cell, recordings, kept, seed, entry_cls)
              if kept else {"recordings_completed": {"value": 0,
                                                     "limit": 1}})
    correct = bool(completed) and failed == 0 and passes(
        {k: c for k, c in checks.items() if k != "recordings_completed"})
    for k, c in checks.items():
        log(f"{k}: {c['value']} (limit {c['limit']})")
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv: list[str], t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(bench, args.workload)
    # the port builds its kernel library into pymodem_tpu_torch/_build/,
    # inside the checkout; it compiles nothing else (no Triton, no
    # torch.utils.cpp_extension)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the port on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    log(f"card: {_power_limit()}")
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t0)
    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0
