"""Time kernels at each value of a compile-time constant of their design,
1, 2, 4 and 8, on one NVIDIA GPU:

- K12, the float64 four-level slicer
  (``pymodem_tpu_torch/csrc/four_level_slicer_f64.cu``): ``kValueWarps``,
  the warps that form the ring values |x| * 2 / 3 a tile ahead of the
  lanes, at the 4FSK bank's f64 shape (1224 lanes of 252158 samples,
  window 16) and at the executor's one lane (1 x 2879186, window 1);
- K13, the float64 AGC alone (``csrc/coherent_loop_f64.cu``):
  ``kAgcGainWarps``, the warps that form the AGC's quotients a tile behind
  the lanes, at the shape of the ``qpsk2400_sweep8`` bank's shared lanes
  at f64 (118 x 300838);
- K9, the AX.25/HDLC deframer (``csrc/ax25_deframe.cu``):
  ``kWarpsPerRow``, the warps of the block that walks a row, at the AX.25
  sweep's shape (920 rows of 1568 bytes).

The script copies the kernel's source and the headers into a temporary
directory once for each value and sets the constant there, builds every
copy through the port's own build (``_ext.build``, one child process a
copy, in parallel), then in one process points the port at each build in
turns (1, 2, 4, 8, 8, 4, 2, 1): each build is held bitwise against the
plain twin (K12: ``ops/slicers.four_level_slice`` and K13:
``dsp/agc.agc_follower`` on the first 4100 samples of every lane; K9:
``codecs/ax25_device.ax25_deframe`` on the first 64 rows and on 48 rows at
an odd K) and timed through its wrapper with CUDA events, the calls queued
behind a sleep on the card so that the events time the kernels and not
the host's launches.  Inputs are made from a seed: 4FSK symbols at 10
samples a symbol with noise and a sync preamble every 2000 symbols; a
noisy 1200 Bd carrier at 44.1 kHz and the BPSK-1200 preset's AGC rows at
normal 2; AX.25 frames of 60-byte payloads between runs of flags, at each
row's own offset, with runs of ones, a row of all ones and counts of 0,
short and past K among them.  Needs a CUDA GPU and nvcc; imports no JAX.

    python tools/design_sweep.py [--kernels K12 K13 K9] [--reps 10]
        [--seed 18]

Prints one line a kernel and value, each with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUES = (1, 2, 4, 8)
# kernel -> (source, constant)
DESIGNS = {
    "K12": ("four_level_slicer_f64.cu", "kValueWarps"),
    "K13": ("coherent_loop_f64.cu", "kAgcGainWarps"),
    "K9": ("ax25_deframe.cu", "kWarpsPerRow"),
}
CUT = 4100
# ~25 ms of the card's clock: longer than the host takes to queue the calls
SLEEP_CYCLES = 50_000_000
DEMAP = (1, 0, 2, 3)


def _use(src_dir: str):
    """The port's build pointed at the sources of ``src_dir``."""
    from pymodem_tpu_torch import _ext as ext

    ext.CSRC_DIR = os.path.join(src_dir, "csrc")
    ext.BUILD_DIR = os.path.join(src_dir, "_build")
    ext._library.cache_clear()
    return ext


def _fsk4_lanes(L, T, seed, dev):
    """(x, lane_params): L lanes of T float64 4FSK baseband samples."""
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    sps = 10.0
    n_sym = int(T / sps) + 2
    levels = np.array([-3.0, -1.0, 1.0, 3.0])
    sym = levels[g.integers(0, 4, (L, n_sym))]
    # a preamble of alternating symbols every 2000 (the sync patterns)
    for start in range(0, n_sym - 64, 2000):
        sym[:, start:start + 64] = np.tile([3.0, -3.0], 32)
    idx = ((np.arange(T)[None, :] + g.integers(0, 10, (L, 1))) / sps)
    x = np.take_along_axis(sym, idx.astype(np.int64), 1)
    x = x + 0.3 * g.standard_normal((L, T))
    lp = np.stack([np.full(L, sps), np.full(L, 0.75)])
    return (torch.from_numpy(np.ascontiguousarray(x)).to(dev),
            torch.from_numpy(lp).to(dev))


def _agc_lanes(L, T, seed, dev):
    """(x, rows): L lanes of a noisy 1200 Bd BPSK carrier at 44.1 kHz,
    float64, and the AGC rows of the BPSK-1200 preset at normal 2."""
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    t = np.arange(T) / 44100.0
    k = np.arange(T) * 1200 // 44100
    sym = (g.integers(0, 2, (L, k[-1] + 1)) * 2 - 1)[:, k]
    x = 14.0 * sym * np.cos(2 * np.pi * (1500.0 + g.uniform(-8, 8, (L, 1)))
                            * t) + 1.4 * g.standard_normal((L, T))
    rows = np.array([500 / 44100 * 2, 50 / 44100 * 2, 1.0, 1 / 44100, 1.0])
    # (the column gather leaves the product in Fortran order)
    return (torch.from_numpy(np.ascontiguousarray(x)).to(dev),
            torch.from_numpy(np.repeat(rows[:, None], L, 1)).to(dev))


def _ax25_rows(N, K, seed, dev):
    """(rows, counts): N rows of K bytes of flag-filled AX.25 traffic, with
    runs of ones, a row of all ones and counts of 0, short and past K."""
    import numpy as np
    import torch

    from pymodem_tpu_torch.synth import encode as enc

    g = np.random.default_rng(seed)
    bits = []
    while len(bits) < 8 * (2 * K + 64):
        payload = bytes(g.integers(32, 127, 60).astype(np.uint8))
        bits += [0, 1, 1, 1, 1, 1, 1, 0] * int(g.integers(20, 200))
        bits += enc.hdlc_encode(enc.ax25_ui_frame("KI5ABC", "N0CALL",
                                                  payload), flag_count=1)
    line = np.array(bits, np.uint8)
    rows = np.empty((N, K), np.uint8)
    for r in range(N):
        off = int(g.integers(0, len(line) - 8 * K))
        rows[r] = np.packbits(line[off:off + 8 * K])
    rows[1] = 0xFF
    for r in range(2, 40):
        at = int(g.integers(0, 8 * K - 80))
        seg = np.unpackbits(rows[r])
        seg[at:at + r] = 1
        rows[r] = np.packbits(seg)
    counts = np.full(N, K, np.int32)
    counts[40:48] = g.integers(-3, K + 50, 8)
    return (torch.from_numpy(rows).to(dev),
            torch.from_numpy(counts).to(dev))


def _time(fn, reps):
    """Mean ms of ``reps`` calls of ``fn`` on the card.  A sleep on the
    card ahead of the calls lets the host queue them all before the card
    reaches them, so the events time the kernels, not the host's launches
    (K9 takes less time than its wrapper's host work)."""
    import torch

    fn()  # warm
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cases(kernel, seed, dev):
    """[(label, check, timed)]: ``check()`` whether the build equals the
    twin, ``timed`` the call to time."""
    import torch

    if kernel == "K12":
        from pymodem_tpu_torch.ops.slicers import (
            four_level_slice,
            four_level_slice_f64_lanes,
        )

        out = []
        for L, T, window in ((1224, 252158, 16), (1, 2879186, 1)):
            x, lp = _fsk4_lanes(L, T, seed, dev)
            cut = x[:, :CUT].contiguous()
            want = four_level_slice(cut, lp, DEMAP, window)

            def check(cut=cut, lp=lp, window=window, want=want):
                return torch.equal(
                    four_level_slice_f64_lanes(cut, lp, DEMAP, window), want)

            out.append((f"{L}x{T} window {window}", check,
                        lambda x=x, lp=lp, window=window:
                        four_level_slice_f64_lanes(x, lp, DEMAP, window)))
        return out
    if kernel == "K13":
        from pymodem_tpu_torch.dsp.agc import agc_f64_lanes, agc_follower

        x, lp = _agc_lanes(118, 300838, seed, dev)
        want = agc_follower(x[:, :CUT].contiguous(), lp)
        return [("118x300838",
                 lambda: torch.equal(agc_f64_lanes(x[:, :CUT], lp), want),
                 lambda: agc_f64_lanes(x, lp))]
    from pymodem_tpu_torch.codecs.ax25_device import (
        ax25_deframe,
        ax25_deframe_rows,
    )

    rows, counts = _ax25_rows(920, 1568, seed, dev)
    head = rows[:64].contiguous(), counts[:64].contiguous()
    odd = rows[:48, :1567].contiguous(), counts[:48].clamp(max=1567)
    wants = [ax25_deframe(r, c, 8, 18, 1023) for r, c in (head, odd)]

    def check():
        return all(
            all(torch.equal(a, b) for a, b in
                zip(ax25_deframe_rows(r, c, 8, 18, 1023), want))
            for (r, c), want in zip((head, odd), wants))

    return [("920x1568", check,
             lambda: ax25_deframe_rows(rows, counts, 8, 18, 1023))]


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs="+", default=list(DESIGNS),
                    choices=list(DESIGNS))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=18)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.build:
        _use(args.build).build()
        return 0
    import torch

    dev = torch.device("cuda")
    csrc = os.path.join(ROOT, "pymodem_tpu_torch", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for kernel in args.kernels:
            source, constant = DESIGNS[kernel]
            pattern = re.compile(rf"constexpr int {constant} = \d+;")
            for v in VALUES:
                d = dirs[kernel, v] = os.path.join(tmp, f"{kernel}_{v}")
                # the kernel's source and the headers: a build of its own
                shutil.copytree(csrc, os.path.join(d, "csrc"),
                                ignore=lambda _, names: [
                                    f for f in names if f.endswith(".cu")
                                    and f != source])
                path = os.path.join(d, "csrc", source)
                with open(path) as fh:
                    text, subs = pattern.subn(
                        f"constexpr int {constant} = {v};", fh.read())
                if subs != 1:
                    raise RuntimeError(f"{source}: {constant} not found once")
                with open(path, "w") as fh:
                    fh.write(text)
        builds = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                    "--build", d]) for d in dirs.values()]
        if any(p.wait() != 0 for p in builds):
            raise RuntimeError("a build failed")
        smi = _smi()
        for kernel in args.kernels:
            cases = _cases(kernel, args.seed, dev)
            ms = {(v, label): [] for v in VALUES for label, *_ in cases}
            for v in (*VALUES, *reversed(VALUES)):
                _use(dirs[kernel, v])
                for label, check, timed in cases:
                    if not check():
                        raise AssertionError(
                            f"{kernel} at {DESIGNS[kernel][1]} = {v} differs "
                            f"from its twin ({label})")
                    ms[v, label].append(_time(timed, args.reps))
            for label, *_ in cases:
                for v in VALUES:
                    t = ms[v, label]
                    mean = sum(t) / len(t)
                    print(f"{kernel} at {DESIGNS[kernel][1]} = {v}: bitwise "
                          f"equal to its twin; {mean:.4f} ms at {label} "
                          f"(turns {', '.join(f'{x:.4f}' for x in t)}; "
                          f"{args.reps} launches each) [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
