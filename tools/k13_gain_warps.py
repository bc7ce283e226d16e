"""Time kernel K13 (the float64 AGC alone, in
``pymodem_tpu_torch/csrc/coherent_loop_f64.cu``) at 1, 2, 4 and 8 gain
warps on one NVIDIA GPU.

The count is the compile-time constant ``kAgcGainWarps``.  This script
copies the port's kernel sources into a temporary directory once for each
count and sets the constant there; one child process for each count then
builds its copy through the port's own build (``_ext.build``, in parallel),
and a child process a turn checks the build bitwise against the plain twin
(``dsp/agc.agc_follower``) on the first 4100 samples and times K13 through
its wrapper (``dsp/agc.agc_f64_lanes``) with CUDA events, in turns (1, 2,
4, 8, 8, 4, 2, 1), at the shape of the ``qpsk2400_sweep8`` bank's shared lanes at
f64.  The input is a noisy 1200 Bd carrier at 44.1 kHz made from a seed;
the AGC rows are the BPSK-1200 preset's at normal 2.  Needs a CUDA GPU and
nvcc; imports no JAX.

    python tools/k13_gain_warps.py [--lanes 118] [--samples 300838]
        [--reps 5] [--seed 17]

Prints one line per count, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = (1, 2, 4, 8)
SOURCE = "coherent_loop_f64.cu"
CONSTANT = re.compile(r"constexpr int kAgcGainWarps = \d+;")
CUT = 4100


def _use(src_dir: str):
    """The port's build pointed at the sources of ``src_dir``."""
    sys.path.insert(0, ROOT)
    from pymodem_tpu_torch import _ext

    _ext.CSRC_DIR = os.path.join(src_dir, "csrc")
    _ext.BUILD_DIR = os.path.join(src_dir, "_build")
    return _ext


def _child_time(src_dir: str, lanes: int, samples: int, reps: int,
                seed: int) -> dict:
    """One turn: K13 of ``src_dir``'s build against its twin on the cut,
    then the mean ms of ``reps`` launches at full shape."""
    _use(src_dir)
    import numpy as np
    import torch

    from pymodem_tpu_torch.dsp.agc import agc_f64_lanes, agc_follower

    dev = torch.device("cuda")
    L, T = lanes, samples
    g = np.random.default_rng(seed)
    t = np.arange(T) / 44100.0
    k = np.arange(T) * 1200 // 44100
    sym = (g.integers(0, 2, (L, k[-1] + 1)) * 2 - 1)[:, k]
    x = 14.0 * sym * np.cos(2 * np.pi * (1500.0 + g.uniform(-8, 8, (L, 1)))
                            * t) + 1.4 * g.standard_normal((L, T))
    # (the column gather leaves the product in Fortran order)
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rows = np.array([500 / 44100 * 2, 50 / 44100 * 2, 1.0, 1 / 44100, 1.0])
    lp = torch.from_numpy(np.repeat(rows[:, None], L, 1)).to(dev)
    equal = torch.equal(agc_f64_lanes(x[:, :CUT], lp),
                        agc_follower(x[:, :CUT].contiguous(), lp))
    agc_f64_lanes(x, lp)  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        agc_f64_lanes(x, lp)
    end.record()
    torch.cuda.synchronize()
    return {"equal": equal, "ms": start.elapsed_time(end) / reps}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=118)
    ap.add_argument("--samples", type=int, default=300838)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.build:
        _use(args.build).build()
        return 0
    if args.time:
        print(json.dumps(_child_time(args.time, args.lanes, args.samples,
                                     args.reps, args.seed)))
        return 0

    def child(*flags):
        return [sys.executable, os.path.abspath(__file__),
                "--lanes", str(args.lanes), "--samples", str(args.samples),
                "--reps", str(args.reps), "--seed", str(args.seed), *flags]

    csrc = os.path.join(ROOT, "pymodem_tpu_torch", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for n in COUNTS:
            dirs[n] = os.path.join(tmp, f"gw{n}")
            shutil.copytree(csrc, os.path.join(dirs[n], "csrc"))
            path = os.path.join(dirs[n], "csrc", SOURCE)
            with open(path) as fh:
                text, subs = CONSTANT.subn(
                    f"constexpr int kAgcGainWarps = {n};", fh.read())
            if subs != 1:
                raise RuntimeError(f"{SOURCE}: kAgcGainWarps not found once")
            with open(path, "w") as fh:
                fh.write(text)
        builds = [subprocess.Popen(child("--build", dirs[n]))
                  for n in COUNTS]
        if any(p.wait() != 0 for p in builds):
            raise RuntimeError("a build failed")
        ms = {n: [] for n in COUNTS}
        for n in (*COUNTS, *reversed(COUNTS)):
            proc = subprocess.run(child("--time", dirs[n]),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"K13 at {n} gain warps: exit "
                                   f"{proc.returncode}\n{proc.stderr[-3000:]}")
            turn = json.loads(proc.stdout.strip().splitlines()[-1])
            if not turn["equal"]:
                raise AssertionError(f"K13 at {n} gain warps differs from "
                                     "its twin")
            ms[n].append(turn["ms"])
    smi = _smi()
    for n in COUNTS:
        mean = sum(ms[n]) / len(ms[n])
        print(f"K13 at {n} gain warp(s): bitwise equal to its twin on "
              f"{args.lanes}x{CUT}; {mean:.3f} ms at {args.lanes}x"
              f"{args.samples} (turns {', '.join(f'{v:.3f}' for v in ms[n])};"
              f" {args.reps} launches each), "
              f"{mean * 1e6 / args.samples:.1f} ns a step [{smi}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
