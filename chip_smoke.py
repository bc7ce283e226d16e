#!/usr/bin/env python3
"""Smoke run of ``pymodem_tpu_torch``, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Drives the port's four main paths on the default route, the device codecs,
through ``run_plan_banked`` and through its CLI, holds the device codecs'
packets against the host codecs' on the same arrays, and holds every
hand-written kernel (K1-K16) against its plain PyTorch twin:

* the AFSK path: the banked AFSK-300 IL2P+CRC decode of 600 s of 8 kHz
  int16 audio (kernels K1 binary slicer, K2 AFSK PLL + AGC);
* the PSK path: banked BPSK-1200, QPSK-2400 and MPSK BPSK-1200 IL2P+CRC
  decodes of 600 s of 44.1 kHz int16 audio each (kernels K3 BPSK Costas +
  AGC, K4 AGC, K6 MPSK loop, K7 quadrature slicer, and K1 again);
* the FSK and Costas-QPSK path: banked FSK-9600 (96 kHz), 4FSK-9600
  (48 kHz) and Costas QPSK-2400 (44.1 kHz) IL2P+CRC decodes of 600 s each
  (kernels K8 four-level slicer, K5 QPSK Costas + AGC, and K1, K7 again);
* the AX.25 path: an 8-chain AFSK-1200 AX.25 space-gain sweep (44.1 kHz)
  and a mixed AFSK-300 AX.25/IL2P+CRC bank (8 kHz), 600 s each (kernels
  K9 AX.25 deframer, K1 again);
* the other front doors, on those paths' recordings: ``run_banked_many``,
  ``run_banked_files``, ``run_plans_banked_pipelined``, the sequential
  executor (every family, its kernels at one lane), the resilient retry
  and the decode server (kernels K1-K9 again), all with
  ``resilient=False`` but the retry phase;
* the streaming decoder (``runtime/stream.StreamDecoder``): the 64-chain
  sweep over an hour in 2-minute chunks, the PLL sweep and the mixed
  AX.25/IL2P bank over 600 s, and a checkpoint (kernels K1, K2, K9 again);
* the float64 parity mode (``PYMODEM_TPU_TORCH_X64``) on the card: the
  executor and ``run_plan_banked`` at float64 for every family (kernels
  K10 binary slicer, K11 AGC + AFSK PLL / BPSK Costas loop, K12
  four-level slicer, K13 AGC, K14 QPSK Costas loop, K15 MPSK loop, K16
  quadrature slicer), its CLI, the synthesizer's round trip, and the
  multi-recording front doors, the stream and the CLI batch at float64;
* the sharded runtime (``runtime/sharded.run_banked_sharded`` over a
  ('chain', 'time') DeviceMesh) on one rank and on two ranks sharing the
  card, against ``run_banked`` (kernels K1, K2, K4, K6, K7, K9, K10 and
  K11 again).

Phases, each printing one line with its seconds:

1. environment: torch and CUDA versions, the card, its power limit;
2. build every kernel from ``pymodem_tpu_torch/csrc`` with nvcc (one
   process per source, in parallel);
3. the sweep bank's basebands on the device against the same demod on the
   CPU (on a failure it prints the TF32 and precision settings, the torch,
   CUDA and cuBLAS versions, where the largest difference sits, each
   side's error against a float64 CPU demod and whether a second device
   computation repeats the first, then fails); K1 against its twin on the
   64-chain sweep bank's own basebands at the full lane count, on a slice
   whose rows it copies as they are and one it copies padded (each route
   checked), windows 1 and the bank's: bitwise; K1 timed at full shape
   with ns a step, the bound and its time before the redesign;
4. K2 against its twin on the 8-chain PLL bank's own shared rows and
   ``row_of_lane`` at the full lane count, on a slice whose rows it copies
   as they are and one it copies padded (each route checked): bitwise;
   timed at full shape with ns a step, the bound (the shared rows read
   once) and its time before the redesign;
5. the AFSK path end to end, the kernels' launch counters set to 0 just
   before and read just after: the 64-chain space-gain sweep, the PLL
   inverted pair and the 8-chain PLL carrier sweep, each decoding every
   synthesised frame, payload for payload, with no rejected packet, and
   its peak device memory beside the host-codec route's; then WARM_RUNS
   warm reruns of each for wall times and chain-Msamples/s at the median,
   failing if one sends any block to the host fallback; and a split of
   one run into device stages, device codec with its readback, host
   packet build and the host codec on the same ``dispatch_bank`` arrays,
   whose packets must equal the device codec's;
6. the CLI as a subprocess on a WAV and an AFSK JSONL config;
7. K3 (on the BPSK sweep's shared rows, as K2 in 4), K4 (over the B
   shared lanes of the QPSK sweep and the C*B lanes of the MPSK pair), K6
   and K7 (2 bits per decision on the QPSK sweep, 1 on the pair) against
   their twins on the PSK banks' own inputs (all lanes, two slices that
   are not a multiple of the kernels' tiles, one whose rows they copy as
   they are and one they copy padded, each route checked): bitwise; each
   kernel timed at its full main-path shape with ns a step, the bound and
   its time before the redesign, K4 with its padded-row copy; K1 checked
   and timed as in 3 on the BPSK sweep's basebands;
8. the PSK path end to end as in 5, counters set to 0 just before and read
   just after (launches and padded-row copies per bank and per path):
   ``bpsk1200_sweep8`` (8 ``bpsk`` chains, carriers 1500 + 0.25 i Hz),
   ``qpsk2400_sweep8`` (8 ``mpsk`` qpsk_2400 chains, the same carriers,
   pre-shared) and ``mpsk_bpsk1200_pair`` (2 ``mpsk`` bpsk_1200 chains, AGC
   attack 500 and 400, not shared), each decoding every frame with none
   rejected;
9. the CLI as a subprocess on a WAV and a QPSK-2400 JSONL config;
10. K8 (windows 1 and the bank's) and K5 against their twins on the
    banks' own inputs (all lanes, the two slices of K4; K5 on the bank's
    R shared rows and on identity rows, with 17 rows (AGC fused) and 12):
    bitwise; K8's twin on the card against the same twin on the CPU:
    bitwise; each kernel timed at its full main-path shape with ns a step,
    the bound, its padded-row copy and its time before the redesign; K1
    checked and timed as in 3 on the FSK-9600 sweep's basebands;
11. the FSK and Costas-QPSK path end to end as in 5 and 8:
    ``fsk9600_sweep8`` (8 ``fsk`` "9600" chains at 96 kHz, input cutoffs
    6000 + 5 i Hz, binary slicer, G3RUH scrambler),
    ``fsk4_9600_sweep8`` (8 ``fsk`` "4800" chains at 48 kHz, cutoffs
    3000 + 5 i Hz, four-level slicer at 4800 Bd) and
    ``qpsk_costas2400_sweep8`` (8 ``qpsk`` "2400" chains at 44.1 kHz,
    carriers 1800 + 0.25 i Hz, pre-shared), every chain decoding every
    frame, none rejected; and a ``torch.profiler`` trace of
    ``fsk9600_sweep8``'s device codec (top operations, kernel launches);
12. the CLI as a subprocess on a WAV and a 4FSK JSONL config;
13. the device codec forced up its escalation ladder on the card (2
    packet slots a block, 64 candidate slots) on dense AFSK-1200 traffic:
    every frame, packets equal to a roomy run's;
14. K9 against its twin, every output bitwise, on the AX.25 sweep bank's
    own byte rows at its full row count, on edge rows (stuffed zeros,
    aborts, a frame over 1023 bytes, more closing flags than packet slots;
    8 and 2 slots, length caps 1023 and 200) and on the scan's edge rows
    at an odd K of 1571 bytes (runs of ones across 32-bit words and the
    threads', warps' and tiles' spans, all ones, closing flags at every bit
    of a word, back-to-back frames; counts full, 0, short and past K);
    kernel and twin timed at the bank's full shape, the time before the
    redesign beside it;
15. the AX.25 path end to end as in 5, counters set to 0 just before and
    read just after: ``ax25_afsk1200_sweep8`` (8 ``afsk`` "1200" chains,
    space gains 0.9 + 0.025 i, binary slicer 1200 Bd, AX.25, NRZI; 60-byte
    payloads 2.5 s apart, every chain decoding every frame) and
    ``mixed_afsk300_ax25_il2p`` (AFSK-300 correlator chains with IL2P+CRC,
    descrambler invert no and yes, and one AX.25 chain: two codec
    sub-groups; IL2P and AX.25 frames on 1600/1800 Hz tones), each
    decoding every frame with none rejected, device-route packets equal to
    the host route's, no warm run on the host fallback;
16. the CLI as a subprocess on a WAV and an AFSK-1200 AX.25 config;
17. ``run_banked_many(depth=1)`` over three 600 s recordings of
    ``pll_sweep8`` (the AFSK path's audio, and twice with noise added):
    packets equal to solo ``run_banked`` calls, every frame, no sizing
    readback in the warm call (``profiling`` counts), the walls of the
    pipelined call and of the three solo calls; the stream
    synchronisations in one warm submit, by source line (torch's sync
    debug mode; it fails unless there are none), and the pipelined walls with the codec's pinned,
    non-blocking readback against a blocking ``.cpu()`` in ``collect()``;
18. ``run_banked_files`` over 600 (591), 300 and 45 s files of
    ``sweep64`` and ``ax25_afsk1200_sweep8`` (correlator banks, no AGC):
    each file's packets equal to its solo ``run_banked``;
19. ``run_plans_banked_pipelined`` over the AFSK and QPSK-2400 CLI
    configs (60 s each): reports equal to per-job ``run_plan_banked``;
20. the sequential executor, one chain per family (AFSK-300 correlator
    and PLL, BPSK-1200, MPSK QPSK-2400, Costas QPSK-2400, FSK-9600, 4FSK,
    AFSK-1200 AX.25) over 60 s of its path's recording: every frame, 0
    rejected, its family's kernels launched, each kernel at one lane equal
    to its twin on a prefix of its own inputs; seconds a chain;
21. an injected bank failure: ``run_plan_banked`` retries chain by chain
    through the executor on the card, with the JAX package's message;
22. the decode server as a subprocess: one request cold and warm, then
    three queued requests (two configs and an unreadable WAV);
23. the streaming decoder on bench.py's streaming workload: ``sweep64``
    over an hour of 8 kHz int16 (the AFSK path's segment tiled) fed in
    120 s chunks, 16 blocks a step, the device codec: every frame, none
    rejected, packets equal to one-shot ``run_banked`` over the hour chain
    for chain (a correlator bank takes no whole-recording AGC normal);
    peak device memory after the first 10 minutes and after the hour (the
    hour's may exceed the 10 minutes' by 10% at most) beside the one-shot
    run's; a warm pass's wall and chain-Msamples/s beside the one-shot's;
    0 stream synchronisations in the warm feeds (torch's sync debug mode,
    the feeding thread); the tail a CUDA tensor of (ext,) samples
    positioned at the next block;
24. ``pll_sweep8`` (K2) over 600 s in 7,001- and 80,000-sample chunks:
    equal packets, every frame, the one-shot run's payloads chain for
    chain with addresses within rate/40 + 9 symbol periods (the JAX
    package's rule: a stream normalises the AGC per step); a ``state()``
    checkpoint taken halfway, through ``json``, restored into a new
    decoder, giving the uninterrupted stream's packets (its size
    printed); ``mixed_afsk300_ax25_il2p`` over 600 s with the device
    codecs (K9) equal to the host codec packet for packet.

25. K10, K11 (kinds ``afsk_pll`` and ``bpsk``), K12, K13, K14, K15 and
    K16 against their float64 twins, bitwise, on the first 4101 samples
    at the full lane count of the executor's one lane over 60 s of the
    PLL, BPSK-1200, 4FSK, Costas QPSK-2400, MPSK QPSK-2400 and MPSK
    BPSK-1200 recordings and of the f64 banks ``pll_sweep8``,
    ``bpsk1200_sweep8``, ``fsk4_9600_sweep8``, ``qpsk2400_sweep8``,
    ``mpsk_bpsk1200_pair`` and ``qpsk_costas2400_sweep8`` (their own
    inputs: shared rows and ``row_of_lane``, analytic rows, detector
    tables, basebands, windows); each kernel timed at full shape, the
    twins at 4101 samples on the banks; the staged K10-K16 also on views
    of 4100 samples at the rows' own stride (the timed call's route), with
    their dynamic shared memory and whether each full shape's rows went
    through a padded copy;
26. the float64 mode end to end, the launch counters set to 0 before each
    run and read after: the executor (the mode's default route) on 60 s
    of the PLL pair (``afsk_300_pll``), the AFSK-300 correlator,
    BPSK-1200, FSK-9600, 4FSK, Costas QPSK-2400, MPSK QPSK-2400 and MPSK
    BPSK-1200 chains, and ``run_plan_banked`` at f64 on ``pll_pair``,
    ``pll_sweep8``, an 8-chain space-gain sweep (``F64_SWEEP_GAINS``, no
    scale row at f64), ``qpsk2400_sweep8``, ``mpsk_bpsk1200_pair`` and
    ``qpsk_costas2400_sweep8`` over 600 s: every frame, 0 rejected,
    K10-K16 launched as each family needs and no f32 loop or slicer
    kernel (K1-K8); walls beside the same plans at f32 (the banks' min /
    median / max of WARM_RUNS warm runs), the packets that differ between
    the two, peak device memory, the padded-row copies made for the
    staged K10-K16;
27. the CLI as a subprocess with ``PYMODEM_TPU_TORCH_X64=1`` on the PLL
    pair's config and a few seconds of audio (2 frames): exit 0 and the report of the same
    decode on the CPU twins (``run_decode`` with
    ``PYMODEM_TPU_TORCH_DEVICE=cpu``); then ``python -m
    pymodem_tpu_torch.synth`` on that config and the CLI on the card
    decoding every frame it printed;
28. the float64 mode through the other front doors, counters set to 0
    before each run and read after (none of K1-K8): ``run_banked_many
    (depth=1)`` over 3 x 60 s of ``pll_pair`` (two with noise), packets
    equal to three solo f64 ``run_banked`` calls, 0 stream
    synchronisations in a warm submit; ``run_banked_files`` on the
    space-gain sweep (60, 30 and 15 s files), each file equal to its solo
    run; ``run_plans_banked_pipelined`` over two configs, reports equal
    to per-job ``run_plan_banked``; ``StreamDecoder`` at f64 over 600 s
    of ``pll_sweep8`` in 120 s chunks, equal to the one-shot f64 run by
    the JAX package's rule, a ``state()`` checkpoint halfway restored,
    peak memory and chain-Msamples/s beside the f32 stream; the CLI's
    batch route under ``PYMODEM_TPU_TORCH_X64=1`` with
    ``PYMODEM_TPU_TORCH_RUNTIME=banked``: one pipelined call, outputs
    equal to one-at-a-time runs;
29. the sharded runtime on one rank, this process (NCCL, through a
    ``file://`` store), mesh (1, 1): ``run_banked_sharded`` on ``sweep64``
    and ``pll_sweep8`` over 600 s, a cold call, then SHARDED_WARM_RUNS
    warm ones, the launch counters set to 0 just before the first and
    read just after: packets equal to ``run_banked``'s on the card by
    (address, bytes), K1 (and K2 on the PLL bank) launched, one packed
    gather per codec sub-group and no sizing (``profiling`` counts); warm
    walls, min / median / max, beside ``run_banked``'s;
30. two ranks sharing the card over gloo, spawned by the port's launcher
    (``sharded.spawn``; each rank loads the library phase 2 built), as
    in 29 on every rank: mesh (2, 1) on ``sweep64`` and the dry run's
    mixed IL2P/AX.25 bank (K1, K9; two codec sub-groups, a padded chain),
    mesh (1, 2), the AGC's normal all-reduced over the time shards, on
    ``pll_sweep8``, ``qpsk2400_sweep8`` (K4, K6, K7) and 60 s of the PLL
    pair at float64 (K10, K11); every rank's packets equal, its uploaded
    frame samples (counted) its blocks' rows, within n_audio / n_time +
    blocks per shard x (overlap + trim) + block_len; walls and each
    rank's peak memory; then
    ``sharded.dryrun_multichip(2)``, its packets equal to ``run_banked``'s.

Phases 17-22 and the CLI phases fail if any output holds "banked runtime
failed" or "skipped chain" (the retry's messages), but phase 21's own.

Every bank must launch each kernel of its family at least once in its
main-path run, or the script fails; so must each streaming phase.

Any failure raises and the script exits non-zero.  Without a CUDA GPU, or
outside a checkout of the repository, it exits non-zero before printing a
result.  The last three lines are the card's ``nvidia-smi`` name and power
limit, one JSON object describing each kernel (launches on the main paths,
max abs error against the twin, kernel milliseconds at the full main-path
shape, the twin's on a time slice, the bound; K1 also at the BPSK and
FSK-9600 sweeps' shapes, K10-K16 at their other phase 25 shapes) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

ROOT = os.path.dirname(os.path.abspath(__file__))
RATE = 8000
PSK_RATE = 44100
FSK_RATE = 96000  # the FSK-9600 bank (bench.py:229)
FSK4_RATE = 48000  # the 4FSK bank (bench.py:230)
AX25_RATE = 44100  # the AFSK-1200 AX.25 sweep, at a sound card's rate
SECONDS = 600
# the streaming phase: bench.py's stream_msps workload, an hour of the
# 64-chain sweep in 2-minute chunks (bench.py:202-217)
STREAM_SECONDS = 3600
STREAM_CHUNK_SECONDS = 120
MAX_PACKET_SECONDS = 3.0  # the synthesised AFSK frames' wire time bound
SLICE = 4096  # time slice of the twin comparisons (samples per lane)
# the staged lane kernels' (K1-K8) slices, not multiples of their
# 128-sample tiles: rows the kernels copy as they are (T % 4 == 0), and
# rows they copy padded
ALIGNED_CUT = SLICE + 4
PADDED_CUT = SLICE + 5
# their launch geometry (csrc/lane_tiles.cuh)
LANE_TILES = "32 lanes a block, 128-sample tiles"
# K1-K8 before their redesign: ms at full shape on the main paths (one
# thread per lane, 128-thread blocks, uncoalesced rows; PERF.md, H100
# 80GB HBM3 at 700 W): K1 on the AFSK sweep, K2 on the PLL sweep, K3 on
# the BPSK sweep, K4 on the QPSK sweep's 118 shared lanes and the MPSK
# pair's 186, K5 on the Costas sweep, K6 and K7 on the QPSK sweep, K8 on
# the 4FSK sweep
K1_BEFORE_MS = {"sweep64": 23.994}
K2_BEFORE_MS = 41.365
K3_BEFORE_MS = 109.641
K4_BEFORE_MS = {"qpsk2400_sweep8": 93.461, "mpsk_bpsk1200_pair": 72.236}
K5_BEFORE_MS = 147.222
K6_BEFORE_MS = 130.771
K7_BEFORE_MS = 68.236
K8_BEFORE_MS = 109.962
# K9 before its redesign (one thread a row; PERF.md, H100 80GB HBM3 at
# 700 W), ms at the AX.25 sweep's 920 rows of 1568 bytes
K9_BEFORE_MS = 0.700
K9_DESIGN = ("a bit-parallel scan, a block of 4 warps a row, 16 bytes a "
             "thread a tile, bytes stored in coalesced runs")
# the row length of K9's scan edge rows: odd, so rows start off a 4-byte
# boundary
AX25_SCAN_K = 1571
# ~25 ms of the card's clock, longer than the host takes to queue 20 calls
# of a kernel wrapper (``_time_ms``'s ``queued``)
SLEEP_CYCLES = 50_000_000
# peak device memory of each bank on the host-codec route, before the
# device codec (PERF.md, GiB)
PEAK_HOST_ROUTE_GIB = {
    "sweep64": 3.03, "pll_pair": 0.35, "pll_sweep8": 1.09,
    "bpsk1200_sweep8": 6.55, "qpsk2400_sweep8": 8.85,
    "mpsk_bpsk1200_pair": 2.86, "fsk9600_sweep8": 5.13,
    "fsk4_9600_sweep8": 4.74, "qpsk_costas2400_sweep8": 7.77}
# the forced-escalation phase's first budgets (tests/test_bank_runtime.py's
# forced case): 2 packet slots a block and 64 candidate slots, fixed
FORCED_BUDGETS = dict(max_packets_per_block=2, total_candidates=64)
# the AX.25 path's traffic: APRS-sized payloads, frames 2.5 s apart at
# 1200 Bd and 2.0 s at 300 Bd, the time between them filled with flags (an
# HDLC link's interframe fill): a run of idle bits instead would close a
# CRC-bad frame of idle bytes at the next flag whenever the run lands
# byte-aligned, and where a block's deframer starts mid-run that turns on
# the block's phase
AX25_PAYLOAD = 60
AX25_FILL_FLAGS = {1200: 375, 300: 75}
SEED = 20261016
# warm runs of each bank for its wall time: host-side walls vary from call
# to call by 2x and more (PERF.md section 5)
WARM_RUNS = 3
# phases 29-30 time more warm runs, and print their spread: two processes
# sharing the card vary more than one (PERF.md section 6)
SHARDED_WARM_RUNS = 7
# the H100 SXM's published peaks at its full 700 W:
# HBM bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# and float64 outside the tensor cores (NVIDIA's H100 SXM data sheet)
F64_OPS_PER_S = 34e12
FULL_POWER_W = 700.0
# the float64 phases (25-27): the twins' time slice (4101 samples, as the
# other twin timings) and the space-gain bank's gains (around unity, which
# decodes every frame)
F64_CUT = SLICE + 5
F64_SWEEP_GAINS = [0.97 + 0.01 * i for i in range(8)]
# the f64 kernels before their redesign (one thread a lane; PERF.md,
# H100 80GB HBM3 at 700 W): ms at full shape on the banks at f64 and on
# the executor's lane of a chain
F64_BEFORE_MS = {
    "K10": {"pll_sweep8": 15.431, "bpsk1200_sweep8": 42.846,
            "afsk300_pll": 21.868},
    "K11": {"pll_sweep8": 41.230, "bpsk1200_sweep8": 114.359,
            "afsk300_pll": 116.756},
    "K13": {"qpsk2400_sweep8": 56.579, "mpsk_bpsk1200_pair": 79.353,
            "mpsk_qpsk2400": 386.721, "lane (mpsk_bpsk1200": 386.323},
    "K14": {"qpsk_costas2400_sweep8": 91.574, "qpsk2400_costas": 699.207},
    "K15": {"qpsk2400_sweep8": 90.461, "mpsk_bpsk1200_pair": 119.350,
            "mpsk_qpsk2400": 664.278},
    "K16": {"qpsk2400_sweep8": 42.590, "mpsk_bpsk1200_pair": 53.378,
            "mpsk_qpsk2400": 238.487},
    "K12": {"fsk4_9600_sweep8": 114.072, "lane (fsk4_9600": 663.325}}


def _phase(n: int, what: str, t0: float) -> None:
    print(f"phase {n} {what} ({time.time() - t0:.2f} s)", flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _chain_line(name: str, modem: str, invert: str = "no") -> dict:
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": modem, "config": "300", "options": {}},
        "slicer": {"type": "binary", "config": "300", "options": {}},
        "stream": {"type": "lfsr",
                   "options": {"poly": "0x3", "invert": invert}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }


def _family_line(name: str, modem: str, preset: str, slicer: str,
                 slicer_preset: str, poly: str) -> dict:
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": modem, "config": preset, "options": {}},
        "slicer": {"type": slicer, "config": slicer_preset, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": poly,
                                               "invert": "no"}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}},
    }


PSK_LINES = {
    "bpsk": _family_line("BPSK 1200 Il2Pc", "bpsk", "1200", "binary",
                         "1200", "0x3"),
    "qpsk": _family_line("QPSK 2400 Il2Pc", "mpsk", "qpsk_2400",
                         "quadrature", "qpsk_2400", "0x1"),
    "mpsk_bpsk": _family_line("BPSK 1200 Il2Pc MPSK", "mpsk", "bpsk_1200",
                              "quadrature", "bpsk_1200", "0x3"),
}


# the third path's chains: the reference's fsk_9600.json and 4fsk_9600.json
# shapes (SURVEY.md:115, 128-132; the 4FSK pairing of tests/test_synth.py)
# and bench.py's Costas-QPSK chain (bench.py:330-340)
FSK_LINES = {
    "fsk9600": _family_line("FSK 9600 Il2Pc", "fsk", "9600", "binary",
                            "9600", "0x63003"),
    "fsk4": _family_line("4FSK 9600 Il2Pc", "fsk", "4800", "4level", "4800",
                         "0x1"),
    "qpsk_costas": _family_line("QPSK 2400 Il2Pc Costas", "qpsk", "2400",
                                "quadrature", "qpsk_2400", "0x1"),
}


def _ax25_line(name: str, preset: str) -> dict:
    """An AFSK AX.25 chain line, NRZI as ``ax25_line_bits`` codes the
    frames (poly 0x3, inverted)."""
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": "afsk", "config": preset, "options": {}},
        "slicer": {"type": "binary", "config": preset, "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                               "invert": "yes"}},
        "codec": {"type": "ax25", "options": {}},
    }


AX25_LINES = {"afsk1200": _ax25_line("AFSK 1200 AX25", "1200"),
              "afsk300": _ax25_line("AFSK 300 AX25", "300")}


def _variant(spec, name, **modem):
    # the codec's ident names the decoder in the reports; cross-chain
    # dedup only merges packets of different decoders
    return replace(spec, name=name, modem=replace(spec.modem, **modem),
                   codec=replace(spec.codec, ident=name))


def _banks():
    """The AFSK path's three chain banks: bench.py's 64-chain AFSK-300
    space-gain sweep, the afsk_300_pll-style inverted pair, and an 8-chain
    PLL carrier sweep."""
    from pymodem_tpu_torch.config import build_chain_spec

    def chain(*args):
        return build_chain_spec(float(RATE), _chain_line(*args))

    base = chain("AFSK 300 Il2Pc Correlator", "afsk")
    pll = chain("AFSK 300 Il2Pc PLL", "afsk_pll", "no")
    return {
        "sweep64": [_variant(base, f"s{i}", space_gain=0.7 + 0.005 * i)
                    for i in range(64)],
        "pll_pair": [pll, chain("AFSK 300 Il2Pc PLL inverted", "afsk_pll",
                                "yes")],
        "pll_sweep8": [_variant(pll, f"pll{i}", carrier_freq=1696.0 + i)
                       for i in range(8)],
    }


def _psk_banks():
    """The PSK path's three chain banks at the presets' own widths, as
    bench.py's family sweeps build them (``_family_workload``: carrier
    steps of 0.25 Hz)."""
    from pymodem_tpu_torch.config import build_chain_spec

    def chain(kind):
        return build_chain_spec(float(PSK_RATE), PSK_LINES[kind])

    bpsk, qpsk, mb = chain("bpsk"), chain("qpsk"), chain("mpsk_bpsk")
    return {
        "bpsk1200_sweep8": [_variant(bpsk, f"b{i}",
                                     carrier_freq=1500.0 + 0.25 * i)
                            for i in range(8)],
        "qpsk2400_sweep8": [_variant(qpsk, f"q{i}",
                                     carrier_freq=1500.0 + 0.25 * i)
                            for i in range(8)],
        "mpsk_bpsk1200_pair": [
            mb, _variant(mb, "BPSK 1200 Il2Pc MPSK attack 400",
                         agc=replace(mb.modem.agc, attack_rate=400.0))],
    }


def _fsk_banks():
    """The third path's three chain banks, bench.py's family sweeps
    (``_family_workload``: 8 chains, input cutoffs in steps of 5 Hz,
    carriers in steps of 0.25 Hz), with each bank's sample rate."""
    from pymodem_tpu_torch.config import build_chain_spec

    def sweep(kind, rate, field, start, step):
        base = build_chain_spec(float(rate), FSK_LINES[kind])
        return [_variant(base, f"{kind}_{i}", **{field: start + step * i})
                for i in range(8)]

    return {
        "fsk9600_sweep8": (sweep("fsk9600", FSK_RATE, "input_lpf_cutoff",
                                 6000.0, 5.0), FSK_RATE),
        "fsk4_9600_sweep8": (sweep("fsk4", FSK4_RATE, "input_lpf_cutoff",
                                   3000.0, 5.0), FSK4_RATE),
        "qpsk_costas2400_sweep8": (sweep("qpsk_costas", PSK_RATE,
                                         "carrier_freq", 1800.0, 0.25),
                                   PSK_RATE),
    }


def _ax25_banks():
    """The AX.25 path's two chain banks with each bank's sample rate: an
    APRS receiver's 8-chain AFSK-1200 space-gain sweep around unity
    (preset "1200", binary slicer 1200 Bd, AX.25) at 44.1 kHz, every chain
    decoding every frame; and the reference's afsk_300.json pattern at
    8 kHz, AFSK-300 correlator chains with IL2P+CRC (descrambler invert no
    and yes) and one AX.25 chain in one bank, two codec sub-groups."""
    from pymodem_tpu_torch.config import build_chain_spec

    ax = build_chain_spec(float(AX25_RATE), AX25_LINES["afsk1200"])

    def afsk300(line):
        return build_chain_spec(float(RATE), line)

    return {
        "ax25_afsk1200_sweep8": (
            [_variant(ax, f"ax{i}", space_gain=0.9 + 0.025 * i)
             for i in range(8)], AX25_RATE),
        "mixed_afsk300_ax25_il2p": (
            [afsk300(_chain_line("AFSK 300 Il2Pc Correlator", "afsk")),
             afsk300(_chain_line("AFSK 300 Il2Pc Correlator inverted",
                                 "afsk", "yes")),
             afsk300(AX25_LINES["afsk300"])], RATE),
    }


def _ax25_wire_seconds(size: int, bit_rate: float) -> float:
    """Wire time of one AX.25 UI frame of ``size`` payload bytes: address,
    control and PID (16 bytes), payload and CRC at the worst-case stuffing
    of 6/5, plus 9 flags."""
    return ((16 + size + 2) * 8 * 1.2 + 9 * 8) / bit_rate


def _ax25_line_bits(payloads, fill_flags: int) -> list[int]:
    """NRZI line bits (poly 0x3, inverted, as ``ax25_line_bits`` codes
    them) of AX.25 UI frames with ``fill_flags`` flags before each and
    after the last, led by an HDLC abort (eight ones) that ends whatever
    the deframer collected before them."""
    from pymodem_tpu_torch.synth import encode as enc

    bits = [1] * 8
    for payload in payloads:
        bits += enc.hdlc_encode(enc.ax25_ui_frame("KI5ABC", "N0CALL",
                                                  payload),
                                flag_count=fill_flags)
    bits += [0, 1, 1, 1, 1, 1, 1, 0] * fill_flags
    return enc.scramble_bits(bits, 0x3, invert=True)


def _ax25_audio(chain):
    """600 s of 44.1 kHz int16 AFSK-1200 (1200/2200 Hz) for the AX.25
    sweep: a segment of 3 AX.25 frames of 60-byte payloads 2.5 s apart
    (``_ax25_line_bits``), tiled.  Returns (expected payloads in time
    order, audio, segment length, max_packet_seconds: twice the frame's
    wire time)."""
    import numpy as np

    from pymodem_tpu_torch.synth import fixtures as fx
    from pymodem_tpu_torch.synth import modulate as mod

    rng = np.random.default_rng(SEED)
    sent = fx.payloads(rng, count=3, size=AX25_PAYLOAD)
    m = chain.modem
    seg = mod.to_int16(mod.afsk_modulate(
        _ax25_line_bits(sent, AX25_FILL_FLAGS[1200]), float(AX25_RATE),
        m.symbol_rate, m.mark_freq, m.space_freq))
    reps = SECONDS * AX25_RATE // len(seg)
    mps = 2.0 * _ax25_wire_seconds(AX25_PAYLOAD, m.symbol_rate)
    return list(sent) * reps, np.tile(seg, reps), len(seg), mps


def _mixed_audio():
    """600 s of 8 kHz int16 AFSK-300 at 1600/1800 Hz (tones the "300"
    preset decodes from any block phase): a segment of 3 IL2P+CRC frames
    with 600 idle bits around each (``il2p_line_bits``, scrambler poly
    0x3), then 2 AX.25 frames 2.0 s apart (``_ax25_line_bits``), 30-byte
    payloads, tiled.  Returns (expected payloads in time order, audio,
    segment length, max_packet_seconds: twice the longer frame's wire
    time)."""
    import numpy as np

    from pymodem_tpu_torch.synth import fixtures as fx
    from pymodem_tpu_torch.synth import modulate as mod

    rng = np.random.default_rng(SEED)
    il2p = fx.payloads(rng, count=3, size=30)
    ax25 = fx.payloads(rng, count=2, size=30)
    line = (fx.il2p_line_bits(il2p, polynomial=0x3, invert=False,
                              gap_bits=600)
            + _ax25_line_bits(ax25, AX25_FILL_FLAGS[300]))
    seg = mod.to_int16(mod.afsk_modulate(line, float(RATE), 300.0, 1600.0,
                                         1800.0))
    reps = SECONDS * RATE // len(seg)
    mps = 2.0 * max(_ax25_wire_seconds(30, 300.0),
                    (3 + 15 + 30 + 16 + 4) * 8 / 300.0)
    return (list(il2p) + list(ax25)) * reps, np.tile(seg, reps), len(seg), mps


def _ax25_edge_rows(device):
    """(rows (N, K) uint8, counts (N,) int32) for K9's edge cases: HDLC
    frames among noise, runs of ones (stuffed zeros and aborts, more than
    six ones), a frame over the 1023-byte cap, rows with more closing flags
    than 8 packet slots, and counts of 0, short and past K."""
    import numpy as np
    import torch

    from pymodem_tpu_torch.synth import encode as enc

    g = np.random.default_rng(SEED)
    bits = []
    for i in range(12):
        bits += [1] * int(g.integers(1, 12)) + [0] * int(g.integers(1, 3))
        size = 1100 if i == 3 else int(g.integers(16, 60))
        payload = bytes(g.integers(32, 127, size).astype(np.uint8))
        bits += enc.hdlc_encode(enc.ax25_ui_frame("KI5ABC", "N0CALL",
                                                  payload), flag_count=2)
    bits += [0] * ((8 - len(bits) % 8) % 8)
    stream = np.array(enc.bits_to_bytes_msb(bits), np.uint8)
    n, K = 257, len(stream) + 61
    rows = g.integers(0, 256, (n, K)).astype(np.uint8)
    counts = g.integers(0, K + 60, n).astype(np.int32)
    for r in range(0, n, 2):
        shift = int(g.integers(0, K - len(stream)))
        rows[r, shift:shift + len(stream)] = stream
        counts[r] = shift + len(stream)
    counts[1] = 0
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(counts).to(device))


def _audio():
    """600 s of int16 audio: a 30 s segment of 3 IL2P+CRC frames (30-byte
    payloads, 1842 idle bits before each and after the last) tiled 20
    times, as bench.py tiles its family workloads.  Returns (expected
    payloads in time order, audio).

    The tones are 1600/1800 Hz, the 200 Hz shift of HF 300-baud packet,
    not the "300" preset's correlator tones 1695/1705 Hz: on clean audio
    at a 10 Hz shift the 1 ms tone correlators see a mark/space contrast
    of ~1e-4 of their magnitude, and whether a block decodes then turns on
    its start phase (the JAX package alike).  At 1600/1800 Hz the
    unity-gain correlator chain decodes every frame from any block start,
    and the PLL chains lock to the same audio."""
    import numpy as np

    from pymodem_tpu_torch.synth import fixtures as fx
    from pymodem_tpu_torch.synth import modulate as mod

    rng = np.random.default_rng(SEED)
    sent = fx.payloads(rng, count=3, size=30)
    line = fx.il2p_line_bits(sent, polynomial=0x3, invert=False,
                             gap_bits=1842)
    seg = mod.to_int16(mod.afsk_modulate(line, float(RATE), 300.0, 1600.0,
                                         1800.0))
    reps = SECONDS * RATE // len(seg)
    assert reps * len(seg) == SECONDS * RATE, len(seg)
    return list(sent) * reps, np.tile(seg, reps)


def _family_audio(chain, rate):
    """int16 audio of up to 600 s for a family bank, made as bench.py's
    ``_family_workload`` makes it: one segment of 3 IL2P+CRC frames of 30
    bytes with 2000 idle bits around each, modulated per the chain's own
    spec and tiled.  Returns (expected payloads in time order, audio,
    segment length, max_packet_seconds: twice the frame's wire time)."""
    import numpy as np

    from pymodem_tpu_torch.runtime.bank import _chain_bit_rate
    from pymodem_tpu_torch.synth import fixtures as fx
    from pymodem_tpu_torch.synth import modulate as mod

    rng = np.random.default_rng(SEED)
    sent, seg = fx.synthesize_for_chain(chain, float(rate), rng,
                                        n_frames=3, size=30, gap_bits=2000)
    seg = mod.to_int16(np.asarray(seg))
    reps = SECONDS * rate // len(seg)
    mps = 2.0 * (3 + 15 + 30 + 16 + 4) * 8 / _chain_bit_rate(chain)
    return list(sent) * reps, np.tile(seg, reps), len(seg), mps


def _dense_afsk1200():
    """(chain, payloads, audio): 12 IL2P frames of 24 bytes 200 idle bits
    apart at 1200 Bd, 8 kHz, ~6 frames in each 3.5 s block window -- the
    dense traffic of tests/test_bank_runtime.py's forced-escalation case."""
    import numpy as np

    from pymodem_tpu_torch.config import (
        AFSKModemSpec,
        BinarySlicerSpec,
        ChainSpec,
        IL2PCodecSpec,
        LFSRStreamSpec,
    )
    from pymodem_tpu_torch.synth import fixtures as fx
    from pymodem_tpu_torch.synth import modulate as mod

    rng = np.random.default_rng(SEED)
    sent = fx.payloads(rng, count=12, size=24)
    line = fx.il2p_line_bits(sent, polynomial=0x3, invert=False,
                             gap_bits=200)
    chain = ChainSpec(
        name="dense", modem=AFSKModemSpec(sample_rate=float(RATE)),
        slicer=BinarySlicerSpec(sample_rate=float(RATE), symbol_rate=1200.0,
                                lock_rate=0.75),
        stream=LFSRStreamSpec(polynomial=0x3, invert=False),
        codec=IL2PCodecSpec(ident="dense"))
    audio = mod.afsk_modulate(line, float(RATE), 1200.0, 1200.0, 2200.0)
    return chain, [bytes(p) for p in sent], np.asarray(audio, np.float32)


def _time_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events).
    ``queued``: the calls wait behind a sleep on the card until the host
    has queued them all, so that the events time the card's work alone,
    for a kernel that takes less time than its wrapper's host work."""
    import torch

    fn()  # warm
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _power_limit_w(smi: str) -> float:
    return float(smi.rsplit(",", 1)[1].strip().split()[0])


def _kernel(name, source, replaces, err, ms, plain_ms, n_bytes, n_ops,
            shape, plain_shape, smi, ops_per_s=F32_OPS_PER_S) -> dict:
    """One entry of the kernels line.  ``bound_ms`` is the least time the
    card could take for the same work: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the HBM rate and its float operations over the card's rate for
    their type outside the tensor cores (float32, or ``F64_OPS_PER_S`` for
    the float64 kernels), both scaled down by the power limit when the
    card is set below 700 W.  The lanes' sequential dependency chain is not
    in the bound.  No single PyTorch call computes any of these
    recurrences, so ``library_ms`` is null."""
    scale = min(1.0, _power_limit_w(smi) / FULL_POWER_W)
    t_bytes = n_bytes / (HBM_BYTES_PER_S * scale)
    t_ops = n_ops / (ops_per_s * scale)
    return dict(
        name=name, route="cuda", source=f"pymodem_tpu_torch/csrc/{source}",
        replaces=replaces, launches=0, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, shape=list(shape), plain_shape=list(plain_shape))


def _check_bank(name, result, expected) -> None:
    good = [p for p in result.aggregate.unique
            if p.valid_crc and p.valid_header]
    got = [bytes(p.data[16:-2]) for p in good]
    bad = result.aggregate.count_bad()
    if got != expected or bad:
        per_chain = {c: n for c, n in result.aggregate.decoder_histogram
                     .items()}
        raise AssertionError(
            f"{name}: {len(got)} unique valid packets (expected "
            f"{len(expected)}, payloads equal: {got == expected}), "
            f"{bad} rejected; packets by chain {per_chain}")


def _same(what: str, got, want) -> float:
    """Max abs difference of a kernel output and its twin's; raises unless
    they are equal bitwise (and finite, for floats)."""
    import torch

    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.is_floating_point() and not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: output is not finite")
        err = max(err, float((g.double() - w.double()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{what} differs from its twin (max {err})")
    return err


def _rows_route(*rails) -> bool:
    """Whether the staged lane kernels take ``rails`` as they are: one
    rail by ``_ext.rows_aligned``, two (the two-rail kernels K6, K7, K15,
    K16, one row stride for both) by ``_ext.pair_aligned``."""
    from pymodem_tpu_torch import _ext

    if len(rails) == 2:
        return _ext.pair_aligned(*rails)
    (x,) = rails
    return _ext.rows_aligned(x)


def _same_route(what: str, *rows, aligned: bool) -> None:
    """Raise unless the staged lane kernels (K1-K8, K10-K16)
    take ``rows`` as they are (``aligned``) or through padded copies (not
    ``aligned``)."""
    if _rows_route(*rows) != aligned:
        raise AssertionError(f"{what}: expected rows the kernel copies "
                             f"{'as they are' if aligned else 'padded'}")


def _copy_ms(*rails) -> float:
    """Milliseconds of the padded-row copies the staged kernels make of
    ``rails`` (``_ext.lane_rows``, or ``_ext.lane_rows_pair`` for two),
    0 when they take them as they are."""
    from pymodem_tpu_torch import _ext

    if _rows_route(*rails):
        return 0.0
    copy = _ext.lane_rows_pair if len(rails) == 2 else _ext.lane_rows
    return _time_ms(lambda: copy(*rails), 3)


def _tree_f64(tree):
    """A bank's parameter tree with every float tensor in float64."""
    if isinstance(tree, dict):
        return {k: _tree_f64(v) for k, v in tree.items()}
    return tree.double() if tree.is_floating_point() else tree


def _cublas_version() -> str:
    """The version of the cuBLAS library torch loaded."""
    import torch

    name = f"libcublas.so.{(torch.version.cuda or '12').split('.')[0]}"
    try:
        lib = ctypes.CDLL(name)
    except OSError as exc:
        return f"not found ({exc})"
    parts = []
    for prop in range(3):  # MAJOR_VERSION, MINOR_VERSION, PATCH_LEVEL
        value = ctypes.c_int()
        lib.cublasGetProperty(prop, ctypes.byref(value))
        parts.append(str(value.value))
    return ".".join(parts)


def _check_basebands(bank, cpu_bank, frames, basebands) -> None:
    """The device demod (``basebands`` of ``bank`` over ``frames``) against
    the same code on the CPU, on the first two blocks: f32 sums in another
    order, so a few ulps of the terms, same signs.  On a failure, prints
    what could explain it and raises."""
    import numpy as np
    import torch

    from pymodem_tpu_torch.runtime import bank as tbank

    ref = tbank.bank_basebands(cpu_bank, frames[:2].cpu())
    dev_bb = basebands[:, :2].cpu()
    rel = float((dev_bb - ref).abs().max() / ref.abs().max())
    sign = float((torch.sign(dev_bb) == torch.sign(ref)).double().mean())
    print(f"sweep basebands, device vs CPU on 2 blocks: max |diff| / max "
          f"|ref| = {rel:.3g}, sign agreement {sign:.6f}")
    if rel < 1e-5 and sign > 0.999:
        return
    b = torch.backends

    def precision(backend):
        return getattr(backend, "fp32_precision", "absent")

    print(f"  TF32: matmul allow_tf32 {b.cuda.matmul.allow_tf32}, cuDNN "
          f"allow_tf32 {b.cudnn.allow_tf32}; fp32_precision: matmul "
          f"{precision(b.cuda.matmul)}, cuDNN {precision(b.cudnn)}, mkldnn "
          f"{precision(b.mkldnn)}; float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, cuBLAS "
          f"{_cublas_version()}")
    diff = (dev_bb - ref).abs()
    c, blk, t = (int(i) for i in np.unravel_index(int(diff.argmax()),
                                                  tuple(diff.shape)))
    print(f"  largest |diff| {float(diff.max()):.6g} at chain {c}, block "
          f"{blk}, sample {t}: device {float(dev_bb[c, blk, t])!r}, CPU "
          f"{float(ref[c, blk, t])!r}")
    f64_bank = replace(cpu_bank, params=_tree_f64(cpu_bank.params))
    exact = tbank.bank_basebands(f64_bank, frames[:2].cpu().double())
    scale = float(exact.abs().max())
    for side, bb in (("device", dev_bb), ("CPU", ref)):
        err = (bb.double() - exact).abs()
        print(f"  {side} float32 against a float64 demod on the CPU: max "
              f"|err| / max |ref| {float(err.max()) / scale:.3g}; at the "
              f"largest difference {float(err[c, blk, t]):.6g}")
    again = tbank.bank_basebands(bank, frames)[:, :2].cpu()
    alone = tbank.bank_basebands(bank, frames[:2]).cpu()
    print(f"  a second device demod of all blocks "
          f"{'repeats' if torch.equal(again, dev_bb) else 'differs from'} "
          f"the first (max |diff| {float((again - dev_bb).abs().max()):.3g})"
          f"; a device demod of the two blocks alone: max |diff| to the "
          f"first {float((alone - dev_bb).abs().max()):.3g}, to the CPU "
          f"{float((alone - ref).abs().max()):.3g}")
    raise AssertionError("device basebands disagree with the CPU")


def _packet_rows(by_name) -> dict:
    return {name: [(int(p.streamaddress), bytes(p.data),
                    int(p.bytes_corrected)) for p in pkts]
            for name, pkts in by_name.items()}


def _same_packets(name, got, want, sides=("device route", "host route")
                  ) -> None:
    """Raise unless two runs' {chain: packets} are equal (address, bytes,
    corrections); print the first differences of each chain.  ``sides``
    names the two runs (by default the device and the host codec route on
    the same arrays)."""
    got, want = _packet_rows(got), _packet_rows(want)
    if got == want:
        return
    for chain in sorted(set(got) | set(want)):
        a, b = set(got.get(chain, [])), set(want.get(chain, []))
        if a != b:
            print(f"  {name} {chain}: {sides[0]} only {sorted(a - b)[:3]}, "
                  f"{sides[1]} only {sorted(b - a)[:3]}")
    raise AssertionError(f"{name}: the {sides[0]}'s packets differ from the "
                         f"{sides[1]}'s")


def _profile_summary(events) -> tuple:
    """(kernel launches, kernels run, kernel ms, top operations) of a
    torch.profiler ``key_averages()``: kernel time summed over the device
    rows only (an operator row repeats its kernels' time), the operators
    ranked by the device time of the kernels each launched itself."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events
           if e.device_type != DeviceType.CUDA and dev_us(e) > 0]
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunch"))
    top = [(dev_us(e) / 1e3, e.count, e.key)
           for e in sorted(ops, key=dev_us, reverse=True)[:10]]
    return (launches, sum(e.count for e in kernels),
            sum(dev_us(e) for e in kernels) / 1e3, top)


def _profile_codec(name, bank, plan, groups, arrays) -> None:
    """One torch.profiler trace of the bank's device codec (budgets
    cached): kernel launches, kernel time, and the operators whose kernels
    took the most device time.  The trace is a measurement aid: if the
    profiler cannot trace the card, it says so and the run goes on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pymodem_tpu_torch.runtime import bank as tbank

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            tbank._device_codec_submit_mixed(bank, plan, groups, *arrays, 8,
                                             None)()
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches, n_kernels, kernel_ms, top = _profile_summary(
            prof.key_averages())
    except Exception as exc:  # noqa: BLE001 - the trace is optional
        print(f"bank {name} codec profile: not traced ({exc!r})")
        return
    print(f"bank {name} codec profile (torch.profiler): {launches} kernel "
          f"launches, {n_kernels} kernels, {kernel_ms:.3f} ms of kernel "
          f"time in a {wall:.3f} s call (traced); operators by their "
          f"kernels' device time:")
    for ms, count, key in top:
        print(f"  {ms:9.3f} ms {count:6d} x {key[:80]}")


def _cli(cfg_lines, wav, rate, audio, expected: int) -> str:
    """Run the CLI as a subprocess on ``audio`` and a JSONL config made of
    ``cfg_lines`` plus a report; raises unless it exits 0 and reports
    ``expected`` unique valid packets."""
    from pymodem_tpu_torch.wav_io import write_wav

    with tempfile.TemporaryDirectory() as tmp:
        wav_path = os.path.join(tmp, wav)
        cfg = os.path.join(tmp, "config.json")
        write_wav(wav_path, rate, audio)
        with open(cfg, "w") as fh:
            for line in (*cfg_lines,
                         {"object_name": "report", "object_type": "report",
                          "options": {"style": "decoded_headers"}}):
                fh.write(json.dumps(line) + "\n")
        env = dict(os.environ, PYTHONPATH=ROOT,
                   PYMODEM_TPU_TORCH_DEVICE="cuda")
        proc = subprocess.run(
            [sys.executable, "-m", "pymodem_tpu_torch", cfg, wav_path],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    _no_retry("CLI", proc.stdout)
    line = f"Unique, valid packets:  {expected}"
    if line not in proc.stdout:
        raise AssertionError(f"CLI did not print {line!r}:\n"
                             f"{proc.stdout[-3000:]}")
    return line


# phrases of the resilient retry: the new paths run with resilient=False,
# and no CLI or server output may hold them
RETRY_PHRASES = ("banked runtime failed", "skipped chain")
# the executor phase: 60 s of each family's recording, whole segments
EXECUTOR_SECONDS = 60
# the pipelining phase: int16 noise added to the AFSK recording, so that
# the three recordings differ (-40 dB against its peak)
NOISE_STD = 300.0


def _no_retry(what: str, text: str) -> None:
    hits = [p for p in RETRY_PHRASES if p in text]
    if hits:
        raise AssertionError(f"{what} printed {hits}:\n{text[-3000:]}")


def _whole_segments(sent, wave, seg_len, rate, seconds):
    """(payloads, audio) of the whole segments in the first ``seconds`` of
    a tiled recording (3 frames a segment)."""
    n_seg = max(seconds * rate // seg_len, 1)
    return list(sent[: 3 * n_seg]), wave[: n_seg * seg_len]


def _executor_cases(afsk, psk, fsk, ax):
    """The executor phase's chains, one per family, each with (rate,
    payloads, audio): the first EXECUTOR_SECONDS of the paths' own
    recordings (AFSK-300 correlator and PLL at 8 kHz on the AFSK path's
    audio; BPSK-1200, MPSK QPSK-2400 and Costas QPSK-2400 at 44.1 kHz;
    FSK-9600 at 96 kHz; 4FSK at 48 kHz; AFSK-1200 AX.25 at 44.1 kHz)."""
    from pymodem_tpu_torch.config import build_chain_spec

    sent, wave = afsk
    seg = len(wave) // (SECONDS // 30)
    afsk60 = (RATE,) + _whole_segments(sent, wave, seg, RATE,
                                       EXECUTOR_SECONDS)
    cases = {
        "afsk300": (build_chain_spec(float(RATE), _chain_line(
            "AFSK 300 Il2Pc Correlator", "afsk")),) + afsk60,
        "afsk300_pll": (build_chain_spec(float(RATE), _chain_line(
            "AFSK 300 Il2Pc PLL", "afsk_pll")),) + afsk60,
    }
    for name, line, rate, (sent_, wave_, seg_len, _) in (
            ("bpsk1200", PSK_LINES["bpsk"], PSK_RATE,
             psk["bpsk1200_sweep8"]),
            ("mpsk_qpsk2400", PSK_LINES["qpsk"], PSK_RATE,
             psk["qpsk2400_sweep8"]),
            ("qpsk2400_costas", FSK_LINES["qpsk_costas"], PSK_RATE,
             fsk["qpsk_costas2400_sweep8"]),
            ("fsk9600", FSK_LINES["fsk9600"], FSK_RATE,
             fsk["fsk9600_sweep8"]),
            ("fsk4_9600", FSK_LINES["fsk4"], FSK4_RATE,
             fsk["fsk4_9600_sweep8"]),
            ("afsk1200_ax25", AX25_LINES["afsk1200"], AX25_RATE,
             ax["ax25_afsk1200_sweep8"])):
        cases[name] = (build_chain_spec(float(rate), line), rate) + \
            _whole_segments(sent_, wave_, seg_len, rate, EXECUTOR_SECONDS)
    return cases


def _one_lane_checks(chain, wave, dev):
    """Each kernel of the chain's executor path at one lane against its
    twin on the first SLICE samples of its own inputs (from the whole
    recording ``wave``): bitwise.  Returns (the kernels checked, seconds
    of the chain's device stages: demod, slicer, compaction)."""
    import torch

    from pymodem_tpu_torch import modems
    from pymodem_tpu_torch.dsp.agc import agc_follower, agc_lanes
    from pymodem_tpu_torch.dsp.fir import fir_valid_nd
    from pymodem_tpu_torch.dsp.loops import (
        afsk_pll,
        afsk_pll_lanes,
        bpsk_costas,
        bpsk_costas_lanes,
        mpsk_loop,
        mpsk_loop_lanes,
        qpsk_costas,
        qpsk_costas_lanes,
    )
    from pymodem_tpu_torch.ops.slicers import (
        binary_slice,
        binary_slice_lanes,
        four_level_slice,
        four_level_slice_lanes,
        quadrature_slice,
        quadrature_slice_lanes,
    )
    from pymodem_tpu_torch.runtime.executor import (
        run_slicer,
        slicer_lane_params,
    )

    m, sl = chain.modem, chain.slicer
    params = modems.build_params(m)
    audio = torch.from_numpy(wave).to(dev).to(torch.float32)
    checked = []

    def cut(t):
        return t[..., :SLICE].contiguous()

    if m.kind in ("afsk_pll", "bpsk", "qpsk"):
        x, rows = modems.coherent_loop_inputs(m, params, audio)
        x = cut(x)
        tables = modems.nco_tables(dev)
        kernel, twin, key = {
            "afsk_pll": (afsk_pll_lanes, afsk_pll, "K2"),
            "bpsk": (bpsk_costas_lanes, bpsk_costas, "K3"),
            "qpsk": (qpsk_costas_lanes, qpsk_costas, "K5")}[m.kind]
        tabs = tables[:1] if m.kind == "afsk_pll" else tables
        _same(f"{key} at one lane on {chain.name}", kernel(x, rows, *tabs),
              twin(x, rows, *tabs))
        checked.append(key)
    if m.kind == "mpsk":
        x = fir_valid_nd(audio, params.input_bpf)
        rows = modems.agc_rows(params.agc, x).contiguous()
        xs = cut(x[None])
        _same(f"K4 at one lane on {chain.name}", agc_lanes(xs, rows),
              agc_follower(xs, rows))
        re, im, rows, table, index = modems.mpsk_loop_inputs(m, params,
                                                             audio)
        args = (rows, *modems.nco_tables(dev), table, index)
        _same(f"K6 at one lane on {chain.name}",
              mpsk_loop_lanes(cut(re), cut(im), *args),
              mpsk_loop(cut(re), cut(im), *args))
        checked += ["K4", "K6"]
    torch.cuda.synchronize()
    t0 = time.time()
    base = modems.demod(m, params, audio)
    run_slicer(sl, base)
    torch.cuda.synchronize()
    device_s = time.time() - t0
    lp = slicer_lane_params(sl, dev)
    if sl.kind == "quadrature":
        i_d, q_d = (cut(t[None]) for t in base)
        _same(f"K7 at one lane on {chain.name}",
              quadrature_slice_lanes(i_d, q_d, lp, sl.demap, sl.state_mask,
                                     sl.bits_per_symbol),
              quadrature_slice(i_d, q_d, lp, sl.demap, sl.state_mask,
                               sl.bits_per_symbol))
        checked.append("K7")
    elif sl.kind == "4level":
        xs = cut(base[None])
        _same(f"K8 at one lane on {chain.name}",
              four_level_slice_lanes(xs, lp, sl.demap),
              four_level_slice(xs, lp, sl.demap))
        checked.append("K8")
    else:
        xs = cut(base[None])
        _same(f"K1 at one lane on {chain.name}", binary_slice_lanes(xs, lp),
              binary_slice(xs, lp))
        checked.append("K1")
    return checked, device_s


def _serve_phase(requests_single, queued, device: str) -> dict:
    """The decode server as a subprocess on the card: one request cold
    (the server's first), the same request warm, then ``queued`` requests
    sent together (drained into one batch by the accept window, default
    0.05 s, which every request also waits out).
    ``requests_single`` and each of ``queued`` are (config, wav, expected
    exit code, expected 'Unique, valid packets' count or None).  Raises
    unless every answer has its exit code and count and none holds a
    retry phrase; stops the server.  ``device``: the server's
    PYMODEM_TPU_TORCH_DEVICE.  Returns the request walls."""
    import threading

    from pymodem_tpu_torch.serve import client_request, client_shutdown

    tmp = tempfile.mkdtemp()
    sock = os.path.join(tmp, "serve.sock")
    env = dict(os.environ, PYTHONPATH=ROOT, PYMODEM_TPU_TORCH_DEVICE=device)
    env.pop("PYMODEM_TPU_TORCH_SERVE_BATCH_WINDOW", None)
    log_path = os.path.join(tmp, "server.log")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pymodem_tpu_torch.serve", sock], cwd=ROOT,
        env=env, stdout=log, stderr=subprocess.STDOUT)

    def check(what, answer, code, count):
        got_code, output = answer
        _no_retry(what, output)
        line = f"Unique, valid packets:  {count}"
        if got_code != code or (count is not None and line not in output):
            raise AssertionError(f"{what}: exit {got_code} (expected {code}"
                                 f"), {line!r} expected:\n{output[-3000:]}")

    try:
        for _ in range(600):
            if os.path.exists(sock) or proc.poll() is not None:
                break
            time.sleep(0.1)
        if not os.path.exists(sock):
            raise AssertionError(f"server did not start:\n"
                                 f"{open(log_path).read()[-3000:]}")
        walls = {}
        cfg, wav, code, count = requests_single
        for what in ("cold", "warm"):
            t1 = time.time()
            check(f"served request ({what})",
                  client_request(sock, cfg, wav, timeout=600), code, count)
            walls[what] = time.time() - t1
        answers = [None] * len(queued)

        def ask(i):
            answers[i] = client_request(sock, *queued[i][:2], timeout=600)

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(queued))]
        t1 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        walls["queued"] = time.time() - t1
        for i, (_cfg, _wav, code, count) in enumerate(queued):
            if answers[i] is None:
                raise AssertionError(f"queued request {i}: no answer")
            check(f"queued request {i}", answers[i], code, count)
        client_shutdown(sock)
        proc.wait(timeout=120)
        if proc.returncode != 0:
            raise AssertionError(f"server exited {proc.returncode}:\n"
                                 f"{open(log_path).read()[-3000:]}")
        return walls
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


@contextlib.contextmanager
def _syncs_on_this_thread():
    """Count the stream synchronisations the calling thread makes inside
    the block, by the port's source line that made each, as torch's sync
    debug mode reports them (a ``Counter``).  Other threads (the streaming
    decoder's collector) are not counted."""
    import collections
    import threading
    import traceback
    import warnings

    import torch

    sites = collections.Counter()
    me = threading.current_thread()

    def note(message, *args, **kw_):
        # torch's own notice that the mode is a prototype is not a sync
        if (threading.current_thread() is not me or
                "called a synchronizing CUDA operation" not in str(message)):
            return
        here = [f for f in traceback.extract_stack()
                if f"{os.sep}pymodem_tpu_torch{os.sep}" in f.filename]
        sites[f"{os.path.basename(here[-1].filename)}:{here[-1].lineno}"
              if here else "outside the port"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _submit_syncs(tbank, chains, audio, kw):
    """Stream synchronisations in one warm ``_submit_banked`` of ``chains``
    over ``audio``, by the port's source line that made each (a
    ``Counter``; the collectors are drained after counting)."""
    with _syncs_on_this_thread() as sites:
        collectors = tbank._submit_banked(chains, audio, **kw)
    tbank._drain(collectors)
    return sites


def _front_doors(dev, smi, banks, afsk, psk_audio, fsk_audio, ax_chains,
                 ax_audio, ax_mps, wrappers) -> list[dict]:
    """Phases 17-22, the front doors other than run_plan_banked and the
    one-shot CLI: ``run_banked_many``, ``run_banked_files``,
    ``run_plans_banked_pipelined``, the sequential executor, the resilient
    retry and the decode server, each on ``dev`` with the paths' own
    recordings (``afsk`` is the AFSK path's (payloads, audio)).
    ``wrappers``: the kernel wrappers by key, whose launch counts each path
    sets to 0 before it and reads after.  Returns each path's launches."""
    import io

    import numpy as np
    import torch

    from pymodem_tpu_torch import profiling
    from pymodem_tpu_torch.config import ReportSpec, RunPlan, build_chain_spec
    from pymodem_tpu_torch.runtime import bank as tbank
    from pymodem_tpu_torch.runtime import executor
    from pymodem_tpu_torch.wav_io import write_wav

    expected, audio = afsk
    reports = (ReportSpec("decoded", style="decoded_headers"),)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in wrappers.items()
                if fn.launches}

    # 17. run_banked_many(depth=1) over three recordings of pll_sweep8
    t0 = time.time()
    chains = banks["pll_sweep8"]
    g = np.random.default_rng(SEED)
    recs = [audio] + [np.clip(audio + g.normal(0.0, NOISE_STD, len(audio)),
                              -32768, 32767).astype(np.int16)
                      for _ in range(2)]
    many_kw = dict(max_packet_seconds=MAX_PACKET_SECONDS, device=dev)
    tbank.run_banked_many(chains, recs, depth=1, **many_kw)  # budgets
    zero_counts()
    profiling.reset()
    profiling.enable(True)
    t1 = time.time()
    many = tbank.run_banked_many(chains, recs, depth=1, **many_kw)
    many_walls = [time.time() - t1]
    profiling.enable(False)
    counts = profiling.counts()
    many_launches = read_counts()
    sizing = {k: counts.get(k, 0) for k in ("candidate_budget",
                                            "codec_sizes")}
    if any(sizing.values()) or set(many_launches) != {"K1", "K2"}:
        raise AssertionError(f"warm run_banked_many: sizing readbacks "
                             f"{sizing}, launches {many_launches}")
    solo_walls = []
    for _ in range(2):
        t1 = time.time()
        solo = [tbank.run_banked(chains, r, **many_kw) for r in recs]
        solo_walls.append(time.time() - t1)
        t1 = time.time()
        tbank.run_banked_many(chains, recs, depth=1, **many_kw)
        many_walls.append(time.time() - t1)
    syncs = _submit_syncs(tbank, chains, recs[0], many_kw)
    if syncs:
        raise AssertionError(f"a warm submit synchronised the stream: "
                             f"{dict(syncs)}")
    # the readback the codec submit starts (pinned, non-blocking, waited on
    # by its event) against a blocking .cpu() of the same buffer inside
    # collect(), alternated in this call
    pinned_readback = tbank._start_readback
    readback_walls = {"pinned": [], "blocking": []}
    for kind in ("pinned", "blocking", "blocking", "pinned"):
        tbank._start_readback = (pinned_readback if kind == "pinned" else
                                 lambda t: lambda: t.cpu().numpy())
        try:
            t1 = time.time()
            tbank.run_banked_many(chains, recs, depth=1, **many_kw)
            readback_walls[kind].append(time.time() - t1)
        finally:
            tbank._start_readback = pinned_readback
    for i, (got, want) in enumerate(zip(many, solo)):
        _same_packets(f"pll_sweep8 recording {i}", got, want,
                      ("run_banked_many", "solo run_banked"))
        decoded = [bytes(p.data[16:-2]) for p in max(got.values(), key=len)]
        if decoded != expected:
            raise AssertionError(f"run_banked_many recording {i}: "
                                 f"{len(decoded)} of {len(expected)} frames")
    print(f"run_banked_many(depth=1) over {len(recs)} recordings of "
          f"pll_sweep8 ({SECONDS} s each; two with noise of std "
          f"{NOISE_STD}): packets equal to solo run_banked, every frame; "
          f"warm call: sizing readbacks {sizing}, launches {many_launches},"
          f" stages over 20 ms "
          f"{ {k: round(v, 3) for k, v in profiling.stages().items() if v > 0.02} }"
          f"; walls: run_banked_many "
          f"{', '.join(f'{w:.3f}' for w in many_walls)} s, "
          f"{len(recs)} solo run_banked {', '.join(f'{w:.3f}' for w in solo_walls)}"
          f" s [{smi}]")
    print(f"run_banked_many stream synchronisations in one warm submit "
          f"(torch.cuda sync debug mode): {sum(syncs.values())} "
          f"{dict(syncs.most_common(5))}; walls with the codec's readback "
          f"pinned and non-blocking "
          f"{', '.join(f'{w:.3f}' for w in readback_walls['pinned'])} s, "
          f"with a blocking .cpu() in collect() "
          f"{', '.join(f'{w:.3f}' for w in readback_walls['blocking'])} s "
          f"(order pinned, blocking, blocking, pinned) [{smi}]")
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            tbank.run_banked_many(chains, recs, depth=1, **many_kw)
            torch.cuda.synchronize()
            wall = time.time() - t1
        launches, n_kernels, kernel_ms, top = _profile_summary(
            prof.key_averages())
        print(f"run_banked_many profile (torch.profiler): {launches} kernel "
              f"launches, {kernel_ms:.3f} ms of kernel time in a {wall:.3f} "
              f"s call (traced): the card busy {kernel_ms / 1e3 / wall:.1%}"
              f"; operators by their kernels' device time: "
              f"{[(round(ms, 3), n, key[:40]) for ms, n, key in top[:5]]}")
    except Exception as exc:  # noqa: BLE001 - the trace is optional
        print(f"run_banked_many profile: not traced ({exc!r})")
    del recs, many, solo
    _phase(17, "run_banked_many == solo runs, no sizing readback", t0)

    # 18. run_banked_files over 600, 300 and 45 s files of the correlator
    # sweeps
    t0 = time.time()
    files_launches = {}
    for name, chains, (sent, wave), rate, mps in (
            ("sweep64", banks["sweep64"], (expected, audio), RATE,
             MAX_PACKET_SECONDS),
            ("ax25_afsk1200_sweep8", ax_chains["ax25_afsk1200_sweep8"],
             ax_audio["ax25_afsk1200_sweep8"][:2], AX25_RATE,
             ax_mps["ax25_afsk1200_sweep8"])):
        files = [wave, wave[: 300 * rate], wave[: 45 * rate]]
        zero_counts()
        t1 = time.time()
        batched = tbank.run_banked_files(chains, files,
                                         max_packet_seconds=mps, device=dev)
        wall = time.time() - t1
        launched = read_counts()
        for k, v in launched.items():
            files_launches[k] = files_launches.get(k, 0) + v
        need = {"K1", "K9"} if name.startswith("ax25") else {"K1"}
        if set(launched) != need:
            raise AssertionError(f"run_banked_files {name}: launches "
                                 f"{launched}")
        frames = []
        for fi, f in enumerate(files):
            solo = tbank.run_banked(chains, f, max_packet_seconds=mps,
                                    device=dev)
            _same_packets(f"{name} file {fi} ({len(f) / rate:.0f} s)",
                          batched[fi], solo,
                          ("run_banked_files", "solo run_banked"))
            frames.append(len({bytes(p.data[16:-2]) for pkts in
                               batched[fi].values() for p in pkts}))
        decoded = [bytes(p.data[16:-2]) for p in
                   max(batched[0].values(), key=len)]
        if decoded != sent:
            raise AssertionError(f"run_banked_files {name}: the whole "
                                 f"recording decoded {len(decoded)} of "
                                 f"{len(sent)} frames")
        print(f"run_banked_files {name}: files of "
              f"{', '.join(f'{len(f) / rate:.0f}' for f in files)} s in one "
              f"dispatch, packets equal to each file's solo run_banked, the "
              f"first every frame ({len(sent)}); distinct payloads a file "
              f"{frames}; launches {launched}; wall {wall:.3f} s [{smi}]")
    _phase(18, "run_banked_files == solo runs (correlator banks)", t0)

    # 19. run_plans_banked_pipelined over the AFSK and QPSK-2400 CLI configs
    t0 = time.time()
    afsk_lines = (_chain_line("AFSK 300 Il2Pc Correlator", "afsk"),
                  _chain_line("AFSK 300 Il2Pc PLL", "afsk_pll"))
    plan_afsk = RunPlan(chains=tuple(build_chain_spec(float(RATE), ln)
                                     for ln in afsk_lines), reports=reports)
    plan_qpsk = RunPlan(chains=(build_chain_spec(float(PSK_RATE),
                                                 PSK_LINES["qpsk"]),),
                        reports=reports)
    q_sent, q_wave = _whole_segments(*psk_audio["qpsk2400_sweep8"][:3],
                                     PSK_RATE, EXECUTOR_SECONDS)
    a_sent, a_wave = _whole_segments(expected, audio, len(audio) // (
        SECONDS // 30), RATE, EXECUTOR_SECONDS)
    jobs = [(plan_afsk, a_wave, RATE), (plan_qpsk, q_wave, PSK_RATE),
            (plan_afsk, audio[len(audio) - len(a_wave):], RATE)]
    zero_counts()
    t1 = time.time()
    piped = tbank.run_plans_banked_pipelined(jobs, depth=1, device=dev)
    wall = time.time() - t1
    piped_launches = read_counts()
    if set(piped_launches) != {"K1", "K2", "K4", "K6", "K7"}:
        raise AssertionError(f"pipelined plans: launches {piped_launches}")
    t1 = time.time()
    per_job = [tbank.run_plan_banked(p, a, r, resilient=False, device=dev)
               for p, a, r in jobs]
    solo_wall = time.time() - t1
    for i, (got, want) in enumerate(zip(piped, per_job)):
        if got.reports != want.reports:
            raise AssertionError(f"pipelined job {i}: report differs from "
                                 f"run_plan_banked's")
    for result, n in zip(piped, (len(a_sent), len(q_sent), len(a_sent))):
        if f"Unique, valid packets:  {n}\n" not in result.reports[0]:
            raise AssertionError(f"pipelined job: expected {n} packets")
    print(f"run_plans_banked_pipelined over 3 jobs (AFSK 2-chain config at "
          f"8 kHz, QPSK-2400 at 44.1 kHz, AFSK again; "
          f"{len(a_wave) / RATE:.0f}, {len(q_wave) / PSK_RATE:.1f} and "
          f"{len(a_wave) / RATE:.0f} s): reports "
          f"equal to per-job run_plan_banked; launches {piped_launches}; "
          f"wall {wall:.3f} s, per-job runs {solo_wall:.3f} s [{smi}]")
    _phase(19, "run_plans_banked_pipelined == per-job runs", t0)

    # 20. the sequential executor, one chain per family
    t0 = time.time()
    cases = _executor_cases((expected, audio), psk_audio, fsk_audio,
                            ax_audio)
    exec_launches = {}
    for name, (chain, rate, sent, wave) in cases.items():
        plan_ = RunPlan(chains=(chain,), reports=reports)
        zero_counts()
        t1 = time.time()
        result = executor.run_plan(plan_, wave, rate, resilient=False,
                                   device=dev)
        cold = time.time() - t1
        launched = read_counts()
        t1 = time.time()
        executor.run_plan(plan_, wave, rate, resilient=False, device=dev)
        warm = time.time() - t1
        for k, v in launched.items():
            exec_launches[k] = exec_launches.get(k, 0) + v
        _check_bank(f"executor {name}", result, sent)
        checked, device_s = _one_lane_checks(chain, wave, dev)
        if set(launched) != set(checked):
            raise AssertionError(f"executor {name}: launches {launched}, "
                                 f"kernels of its family {checked}")
        print(f"executor {name} ({chain.modem.kind}, {chain.slicer.kind}, "
              f"{chain.codec.kind}) over {len(wave) / rate:.1f} s at "
              f"{rate} Hz: {len(sent)} frames, 0 rejected; launches "
              f"{launched}; {', '.join(checked)} at one lane bitwise equal "
              f"to their twins on {SLICE} samples; "
              f"{warm:.3f} s a chain warm (first {cold:.3f} s), of which "
              f"device stages {device_s:.3f} s, the rest the host codec "
              f"and packets [{smi}]")
    _phase(20, "sequential executor, every family", t0)

    # 21. an injected bank failure, retried chain by chain on the card
    t0 = time.time()
    real_run_banked = tbank.run_banked

    def broken(*args, **kw):
        raise RuntimeError("injected bank failure")

    buf = io.StringIO()
    tbank.run_banked = broken
    zero_counts()
    try:
        with contextlib.redirect_stdout(buf):
            result = tbank.run_plan_banked(plan_afsk, a_wave, RATE,
                                           device=dev)
    finally:
        tbank.run_banked = real_run_banked
    retry_launches = read_counts()
    want = ("banked runtime failed (RuntimeError: injected bank failure); "
            "retrying chains sequentially")
    if want not in buf.getvalue() or "skipped chain" in buf.getvalue():
        raise AssertionError(f"retry printed:\n{buf.getvalue()}")
    _check_bank("retried plan", result, a_sent)
    if set(retry_launches) != {"K1", "K2"}:
        raise AssertionError(f"retry launches {retry_launches}")
    print(f"injected bank failure: retried chain by chain through the "
          f"executor on {dev}, {len(a_sent)} frames, 0 rejected, no chain "
          f"skipped; "
          f"launches {retry_launches}")
    _phase(21, "injected bank failure retried on the card", t0)

    # 22. the decode server: one request cold and warm, then three queued
    # requests of two configs and an unreadable WAV
    t0 = time.time()
    srv_dir = tempfile.mkdtemp()

    def srv_file(fname, body):
        path = os.path.join(srv_dir, fname)
        if fname.endswith(".wav"):
            write_wav(path, *body)
        else:
            with open(path, "w") as fh:
                for line in (*body, {"object_name": "report",
                                     "object_type": "report",
                                     "options": {"style": "decoded_headers"}}):
                    fh.write(json.dumps(line) + "\n")
        return path

    afsk_cfg = srv_file("afsk.json", afsk_lines)
    qpsk_cfg = srv_file("qpsk.json", (PSK_LINES["qpsk"],))
    afsk_wav = srv_file("afsk.wav", (RATE, a_wave))
    qpsk_wav = srv_file("qpsk.wav", (PSK_RATE, q_wave))
    walls = _serve_phase(
        (afsk_cfg, afsk_wav, 0, len(a_sent)),
        [(afsk_cfg, afsk_wav, 0, len(a_sent)),
         (qpsk_cfg, qpsk_wav, 0, len(q_sent)),
         (qpsk_cfg, os.path.join(srv_dir, "missing.wav"), 4, None)],
        dev.type)
    print(f"decode server on {dev.type}: a request of the AFSK config "
          f"({len(a_wave) / RATE:.0f} s) "
          f"cold {walls['cold']:.3f} s, warm {walls['warm']:.3f} s; three "
          f"queued requests (AFSK, QPSK-2400, an unreadable WAV: exit 4) "
          f"{walls['queued']:.3f} s; answers as expected, no retry [{smi}]")
    _phase(22, "decode server subprocess", t0)
    return [many_launches, files_launches, piped_launches, exec_launches,
            retry_launches]


def _by_chain(chains, packets) -> dict:
    """A stream's emitted packets by chain (each chain's codec ident is
    its name), in emission order."""
    out = {c.name: [] for c in chains}
    for p in packets:
        out[p.source_decoder].append(p)
    return out


def _stream(chains, wave, rate, chunk, on_feed=None, **kw):
    """Feed ``wave`` to a new StreamDecoder on the card ``chunk`` samples at
    a time, then flush; returns (decoder, emitted packets).
    ``on_feed(i, dec, feed)`` runs feed i itself when given."""
    from pymodem_tpu_torch.runtime.stream import StreamDecoder

    dec = StreamDecoder(chains, rate, **kw)
    out = []
    for i, s in enumerate(range(0, len(wave), chunk)):
        part = wave[s: s + chunk]
        out += (on_feed(i, dec, part) if on_feed is not None
                else dec.feed(part))
    out += dec.flush()
    return dec, out


def _same_by_jax_rule(name, got, want, rate, baud) -> None:
    """The JAX package's rule between a stream and a one-shot run of a
    coherent bank (its AGC normalises per step group in a stream): each
    chain's payloads equal, addresses within rate/40 + 9 sample periods of
    a symbol."""
    window = rate / 40 + 9 * (rate / baud)
    for chain in want:
        a, b = want[chain], got[chain]
        if [p.data for p in a] != [p.data for p in b] or any(
                abs(x.streamaddress - y.streamaddress) >= window
                for x, y in zip(a, b)):
            raise AssertionError(
                f"{name} {chain}: {len(b)} stream packets against "
                f"{len(a)} one-shot, payloads equal "
                f"{[p.data for p in a] == [p.data for p in b]}")


def _stream_phases(dev, smi, banks, afsk, ax_chains, ax_audio, ax_mps,
                   wrappers) -> list[dict]:
    """Phases 23-24, the streaming decoder (``runtime/stream.py``) on the
    card: ``sweep64`` over an hour in 120 s chunks, then ``pll_sweep8``,
    the mixed AX.25/IL2P bank and a checkpoint over 600 s.  ``wrappers``:
    the kernel wrappers by key, whose launch counts each phase sets to 0
    before its main path and reads after.  Returns each phase's
    launches."""
    import numpy as np
    import torch

    from pymodem_tpu_torch.config import ReportSpec, RunPlan
    from pymodem_tpu_torch.runtime import bank as tbank
    from pymodem_tpu_torch.runtime.stream import StreamDecoder

    expected, audio = afsk
    reports = (ReportSpec("decoded", style="decoded_headers"),)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in wrappers.items()
                if fn.launches}

    def check_frames(name, chains, by_name, sent, rate):
        _check_bank(name, tbank._finish_plan(
            RunPlan(chains=tuple(chains), reports=reports), by_name, rate),
            sent)

    # 23. sweep64 over an hour, bench.py's streaming workload
    t0 = time.time()
    chains = banks["sweep64"]
    reps = STREAM_SECONDS // SECONDS
    hour, sent = np.tile(audio, reps), expected * reps
    chunk = STREAM_CHUNK_SECONDS * RATE
    kw = dict(blocks_per_step=16, max_packet_seconds=MAX_PACKET_SECONDS,
              device=dev)
    peaks = {}

    def first_pass(i, dec, part):
        fresh = dec.feed(part)
        if (i + 1) * chunk >= 600 * RATE and "10 min" not in peaks:
            peaks["10 min"] = torch.cuda.max_memory_allocated()
        if (i + 1) * chunk >= len(hour):  # the last feed: drain, check
            fresh += dec.drain()
            st = dec._banks[0]
            ext = st.plan.block_input_len - dec.block_len
            if not (st.tail.is_cuda and tuple(st.tail.shape) == (ext,)
                    and st.tail_block == st.next_block):
                raise AssertionError(
                    f"stream tail: {st.tail.device} {tuple(st.tail.shape)} "
                    f"(ext {ext}), positioned at block {st.tail_block}, "
                    f"next block {st.next_block}")
            peaks["tail"] = (ext, st.tail_block)
        return fresh

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.time()
    dec, out = _stream(chains, hour, RATE, chunk, first_pass, **kw)
    torch.cuda.synchronize()
    cold_wall = time.time() - t1
    peaks["hour"] = torch.cuda.max_memory_allocated()
    launches_23 = read_counts()
    if set(launches_23) != {"K1"}:
        raise AssertionError(f"sweep64 stream: launches {launches_23}")
    streamed = _by_chain(chains, out)
    check_frames("sweep64 stream", chains, streamed, sent, RATE)
    if peaks["hour"] > 1.1 * peaks["10 min"]:
        raise AssertionError(f"stream peak grew with the hour: {peaks}")
    torch.cuda.reset_peak_memory_stats()
    oneshot = tbank.run_banked(chains, hour,
                               max_packet_seconds=MAX_PACKET_SECONDS,
                               device=dev)
    one_peak = torch.cuda.max_memory_allocated()
    _same_packets("sweep64 over an hour", streamed, oneshot,
                  ("stream", "one-shot run_banked"))
    t1 = time.time()
    tbank.run_banked(chains, hour, max_packet_seconds=MAX_PACKET_SECONDS,
                     device=dev)
    torch.cuda.synchronize()
    one_wall = time.time() - t1
    t1 = time.time()
    _, warm_out = _stream(chains, hour, RATE, chunk, **kw)
    torch.cuda.synchronize()
    warm_wall = time.time() - t1
    _same_packets("sweep64 warm stream", _by_chain(chains, warm_out),
                  streamed, ("warm stream", "first stream"))
    syncs, warm_feeds = {}, [0]

    def counted_feed(i, dec_, part):
        if dec_._banks[0].tail is None:  # no step yet: the next is cold
            return dec_.feed(part)
        warm_feeds[0] += 1
        with _syncs_on_this_thread() as sites:
            fresh = dec_.feed(part)
        for k, v in sites.items():
            syncs[k] = syncs.get(k, 0) + v
        return fresh

    _stream(chains, hour, RATE, chunk, counted_feed, **kw)
    if syncs:
        raise AssertionError(f"warm feeds synchronised the stream: {syncs}")
    samples = len(chains) * len(hour)
    print(f"stream sweep64 ({len(chains)} chains) over {STREAM_SECONDS} s "
          f"of {RATE} Hz int16 in {STREAM_CHUNK_SECONDS} s chunks, "
          f"{kw['blocks_per_step']} blocks a step ({dec.block_len} samples "
          f"a block, halo {peaks['tail'][0]} samples on the card): "
          f"{len(sent)} frames decoded, 0 rejected, packets equal to "
          f"one-shot run_banked chain for chain; launches {launches_23}; "
          f"first pass {cold_wall:.3f} s, warm pass {warm_wall:.3f} s = "
          f"{samples / warm_wall / 1e6:.1f} chain-Msamples/s, one-shot "
          f"run_banked warm {one_wall:.3f} s = "
          f"{samples / one_wall / 1e6:.1f} chain-Msamples/s; peak device "
          f"memory after 10 min {peaks['10 min'] / 2**30:.3f} GiB, after "
          f"the hour {peaks['hour'] / 2**30:.3f} GiB, one-shot "
          f"{one_peak / 2**30:.3f} GiB; stream synchronisations in "
          f"{warm_feeds[0]} warm feeds: 0 [{smi}]")
    try:
        from torch.profiler import ProfilerActivity, profile

        for what, fn in (
                ("warm stream", lambda: _stream(chains, hour, RATE, chunk,
                                                **kw)),
                ("warm one-shot run_banked", lambda: tbank.run_banked(
                    chains, hour, max_packet_seconds=MAX_PACKET_SECONDS,
                    device=dev))):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.time()
                fn()
                torch.cuda.synchronize()
                wall = time.time() - t1
            launches, _, kernel_ms, top = _profile_summary(
                prof.key_averages())
            print(f"sweep64 over an hour, {what} (torch.profiler): "
                  f"{launches} kernel launches, {kernel_ms:.3f} ms of kernel "
                  f"time in a {wall:.3f} s call (traced): the card busy "
                  f"{kernel_ms / 1e3 / wall:.1%}; operators by their "
                  f"kernels' device time: "
                  f"{[(round(ms, 3), n, key[:40]) for ms, n, key in top[:5]]}")
    except Exception as exc:  # noqa: BLE001 - the trace is optional
        print(f"sweep64 stream profile: not traced ({exc!r})")
    del hour, oneshot, out, warm_out, dec
    _phase(23, "stream: sweep64 over an hour", t0)

    # 24. pll_sweep8 and the mixed AX.25/IL2P bank over 600 s, and a
    # checkpoint
    t0 = time.time()
    pll = banks["pll_sweep8"]
    kw = dict(max_packet_seconds=MAX_PACKET_SECONDS, device=dev)
    zero_counts()
    runs, walls = {}, {}
    for n in (7001, 80000):
        t1 = time.time()
        runs[n] = _stream(pll, audio, RATE, n, **kw)[1]
        torch.cuda.synchronize()
        walls[n] = time.time() - t1
    mixed, (m_sent, m_wave, _, _) = (ax_chains["mixed_afsk300_ax25_il2p"],
                                     ax_audio["mixed_afsk300_ax25_il2p"])
    m_kw = dict(max_packet_seconds=ax_mps["mixed_afsk300_ax25_il2p"],
                device=dev)
    m_dev = _by_chain(mixed, _stream(mixed, m_wave, RATE, 80000,
                                     **m_kw)[1])
    launches_24 = read_counts()
    if set(launches_24) != {"K1", "K2", "K9"}:
        raise AssertionError(f"phase 24 launches {launches_24}")
    m_host = _by_chain(mixed, _stream(mixed, m_wave, RATE, 80000,
                                      codec="host", **m_kw)[1])
    _same_packets("mixed bank stream", m_dev, m_host)
    check_frames("mixed bank stream", mixed, m_dev, m_sent, RATE)
    oneshot = tbank.run_banked(pll, audio, device=dev, **{
        k: v for k, v in kw.items() if k != "device"})
    by_chunk = {n: _by_chain(pll, out) for n, out in runs.items()}
    _same_packets("pll_sweep8 stream", by_chunk[7001], by_chunk[80000],
                  ("7,001-sample chunks", "80,000-sample chunks"))
    check_frames("pll_sweep8 stream", pll, by_chunk[80000], expected, RATE)
    _same_by_jax_rule("pll_sweep8 stream", by_chunk[80000], oneshot, RATE,
                      pll[0].slicer.symbol_rate)
    chunks = [audio[s: s + 80000] for s in range(0, len(audio), 80000)]
    half = len(chunks) // 2
    first = StreamDecoder(pll, RATE, **kw)
    got = []
    for c in chunks[:half]:
        got += first.feed(c)
    blob = json.dumps(first.state())
    del first
    resumed = StreamDecoder(pll, RATE, **kw)
    resumed.restore(json.loads(blob))
    for c in chunks[half:]:
        got += resumed.feed(c)
    got += resumed.flush()
    _same_packets("pll_sweep8 resumed from a checkpoint", _by_chain(pll, got),
                  by_chunk[80000], ("resumed stream", "uninterrupted"))
    print(f"stream pll_sweep8 over {SECONDS} s in 7,001- and 80,000-sample "
          f"chunks ({walls[7001]:.3f} and {walls[80000]:.3f} s, the first "
          f"with the codec's budgets cold): equal packets, every frame "
          f"({len(expected)}), 0 "
          f"rejected, the one-shot run's payloads chain for chain with "
          f"addresses within rate/40 + 9 symbol periods; a checkpoint after "
          f"{half} of {len(chunks)} chunks, {len(blob)} bytes of JSON, "
          f"restored into a new decoder: the uninterrupted stream's "
          f"packets; mixed_afsk300_ax25_il2p: device codecs equal to the "
          f"host codec packet for packet, every frame ({len(m_sent)}); "
          f"launches {launches_24} [{smi}]")
    _phase(24, "stream: PLL and mixed banks, a checkpoint", t0)
    return [launches_23, launches_24]


def _packet_keys(result) -> list:
    """Every chain's packets as (payload, stream address) tuples."""
    return [(ci, bytes(p.data), int(p.streamaddress))
            for ci, ch in enumerate(result.aggregate.chains) for p in ch]


def _cli_report(cfg, wav, env_extra) -> str:
    """Run the CLI as a subprocess with ``env_extra``; raises unless it
    exits 0; returns its report text (from "Generating" to "Elapsed")."""
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    proc = subprocess.run(
        [sys.executable, "-m", "pymodem_tpu_torch", cfg, wav], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI ({env_extra}) exited {proc.returncode}:"
                             f"\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    _no_retry("CLI", proc.stdout)
    out = proc.stdout
    return out[out.index("Generating"):out.index("Elapsed time")]


def _f64_phases(dev, smi, banks, afsk, psk_chains, psk_audio, fsk_chains,
                fsk_audio, wrappers) -> tuple[dict, dict]:
    """Phases 25-27, the float64 parity mode on the card: K10-K16 against
    their f64 twins; the mode end to end on the executor (its default
    route) and on ``run_plan_banked``, every family; the CLI under
    PYMODEM_TPU_TORCH_X64 against the CPU twins, and the synthesizer's
    round trip.  ``wrappers``: every kernel wrapper by key (K1-K16), whose
    launch counts each run sets to 0 before it and reads after.  Returns
    the kernels-line entries of K10-K16 (launches 0, for the caller to
    fill) and their launches on phase 26's runs (the mode's main path)."""
    import numpy as np
    import torch

    from pymodem_tpu_torch import _ext, modems
    from pymodem_tpu_torch.config import ReportSpec, RunPlan, build_chain_spec
    from pymodem_tpu_torch.dsp.agc import agc_f64_lanes, agc_follower
    from pymodem_tpu_torch.dsp.fir import fir_valid_nd
    from pymodem_tpu_torch.dsp.loops import (
        afsk_pll,
        bpsk_costas,
        coherent_loop_f64_lanes,
        mpsk_loop,
        mpsk_loop_f64_lanes,
        qpsk_costas,
        qpsk_costas_f64_lanes,
    )
    from pymodem_tpu_torch.ops.slicers import (
        binary_slice,
        binary_slice_f64_lanes,
        four_level_slice,
        four_level_slice_f64_lanes,
        quadrature_slice,
        quadrature_slice_f64_lanes,
    )
    from pymodem_tpu_torch.runtime import bank as tbank
    from pymodem_tpu_torch.runtime import executor
    from pymodem_tpu_torch.runtime.executor import slicer_lane_params
    from pymodem_tpu_torch.wav_io import write_wav

    F64 = torch.float64
    expected, audio = afsk
    reports = (ReportSpec("decoded", style="decoded_headers"),)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in wrappers.items()
                if fn.launches}

    # 25. K10-K16 against their f64 twins
    t0 = time.time()
    sources = {
        "K10": ("binary_slicer_f64", "binary_slicer_f64.cu",
                "pymodem_tpu/ops/slicers.py:151"),
        "K11": ("coherent_loop_f64", "coherent_loop_f64.cu",
                "pymodem_tpu/dsp/loops.py:123"),
        "K12": ("four_level_slicer_f64", "four_level_slicer_f64.cu",
                "pymodem_tpu/ops/slicers.py:244"),
        "K13": ("agc_f64", "coherent_loop_f64.cu",
                "pymodem_tpu/dsp/agc.py:27"),
        "K14": ("qpsk_costas_f64", "iq_loop_f64.cu",
                "pymodem_tpu/dsp/loops.py:179"),
        "K15": ("mpsk_loop_f64", "iq_loop_f64.cu",
                "pymodem_tpu/dsp/loops.py:256"),
        "K16": ("quadrature_slicer_f64", "quadrature_slicer_f64.cu",
                "pymodem_tpu/ops/slicers.py:189"),
    }
    held = {}  # key -> [(where, entry)]
    smem = {key: _ext.kernel(entry, ())() for key, entry in (
        ("K10", "binary_slice_f64_smem_bytes"),
        ("K11", "coherent_loop_f64_smem_bytes"),
        ("K12", "four_level_slice_f64_smem_bytes"),
        ("K13", "agc_f64_smem_bytes"),
        ("K15", "mpsk_loop_f64_smem_bytes"),
        ("K16", "quadrature_slice_f64_smem_bytes"))}
    k14_smem = _ext.kernel("qpsk_costas_f64_smem_bytes", (ctypes.c_int,))
    smem["K14"] = {rows: k14_smem(int(rows == 17)) for rows in (17, 12)}
    designs = {
        "K10": "K1's design at f64: a lane warp and a copy warp a block of "
               "32 lanes, 128-sample tiles in 3 stages by bulk copies, sign "
               "and crossing words packed a tile ahead, window codes "
               f"stored in coalesced runs; {smem['K10']} B of dynamic "
               "shared memory",
        "K11": "K2/K3's design at f64: a lane warp, a copy warp (bulk "
               "copies, the AGC follower a tile ahead) and one gain warp "
               "(AGC quotients a tile ahead) a block of 32 lanes, "
               f"64-sample tiles in 5 stages of 2 rails; {smem['K11']} B of "
               "dynamic shared memory",
        "K12": "K8's design at f64: a lane warp, a copy warp (bulk "
               "copies, x > 0 and crossing words packed a tile ahead) and "
               "two value warps (|x| * 2 / 3 a tile ahead) a block of 32 "
               "lanes, 64-sample tiles in 3 stages of 2 rails, the ring a "
               "shared row a lane summed every step, window codes stored "
               f"in coalesced runs; {smem['K12']} B of dynamic shared "
               "memory",
        "K13": "K4's design at f64: a lane warp (the AGC follower, "
               "envelopes into a second rail), a copy warp (bulk copies) "
               "and four gain warps (AGC quotients a tile behind) a block "
               "of 32 lanes, 64-sample tiles in 4 stages of 2 rails; "
               f"{smem['K13']} B of dynamic shared memory",
        "K14": "K5's loop with K11's split of the AGC: with 17 rows a "
               "lane warp, a copy warp (bulk copies, the AGC follower a "
               "tile ahead) and one gain warp (AGC quotients a tile ahead) "
               "a block of 32 lanes, 64-sample tiles in 5 stages of 2 "
               f"rails, {smem['K14'][17]} B of dynamic shared memory; with "
               "12 rows a lane warp and a copy warp, 3 stages, "
               f"{smem['K14'][12]} B; I and Q in place, stored by the copy "
               "warp",
        "K15": "K6's design at f64: a lane warp and a copy warp a block of "
               "32 lanes, 64-sample tiles in 3 stages of 2 rails by bulk "
               "copies, outputs in place stored by the copy warp, the NCO "
               "as one (cos, -sin) double2 (Loop::nco_select), the "
               "detector tables staged as doubles up to 3 of 4096 "
               f"entries; {smem['K15']} B of dynamic shared memory and "
               "8 B a staged table entry",
        "K16": "K7's design at f64: a lane warp and a copy warp a block of "
               "32 lanes, 128-sample tiles in 3 stages of 2 rails by bulk "
               "copies, sign and crossing words of both rails packed a "
               "tile ahead, window codes stored in coalesced runs; "
               f"{smem['K16']} B of dynamic shared memory"}
    print(f"K10-K16, staged: dynamic shared memory {smem} B a block (K14 "
          "by its rows; K15: 8 B more a staged detector-table entry); gain "
          "warps: K11 1 (csrc/coherent_loop_f64.cu kGainWarps), K13 4 "
          "(kAgcGainWarps), K14 1 (csrc/iq_loop_f64.cu kGainWarps); value "
          "warps: K12 2 (csrc/four_level_slicer_f64.cu kValueWarps)")

    def hold(key, where, kernel, twin, x, n_lanes, n_bytes, ops_a_step):
        """``kernel`` against ``twin`` on the first F64_CUT samples of the
        rows ``x`` (or of each rail of a tuple of them) at the full lane
        count: bitwise; the kernel timed at full shape (3 runs a bank's
        lanes, 1 the executor's lane), the twin's call on the cut.  The
        staged K10-K16 are held on two cuts, as K1-K8 are:
        views of the first ALIGNED_CUT samples, which the kernel reads at
        the rows' own stride, by the route of the timed call (as they lie,
        or through ``_ext.lane_rows``' or ``_ext.lane_rows_pair``' padded
        copies), and a contiguous copy of
        the first PADDED_CUT samples, whose odd stride takes the padded
        copy; for them, the full rows' route (the copy's time inside the
        kernel's) and the time before the redesign are printed."""
        rails = x if isinstance(x, tuple) else (x,)
        # (samples, whether the cut is a view of the rows as they lie)
        cuts = ((ALIGNED_CUT, True), (F64_CUT, False))
        err = 0.0
        for n, view in cuts:
            # a fresh copy: .contiguous() keeps a single row's stride
            cut = tuple(r[:, :n] if view else
                        r[:, :n].clone(memory_format=torch.contiguous_format)
                        for r in rails)
            _same_route(f"{key} on {where}, {n} samples", *cut,
                        aligned=view and _rows_route(*rails))
            got = kernel(*cut)
            cut = tuple(c.contiguous() for c in cut)
            # the twin's one call, timed by CUDA events (4101 steps of its
            # launches, no warm-up worth a second call)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = twin(*cut)
            end.record()
            torch.cuda.synchronize()
            plain = start.elapsed_time(end)
            err = max(err, _same(f"{key} on {where}, {n} samples", got,
                                 want))
        ms = _time_ms(lambda: kernel(*rails), 3 if n_lanes > 1 else 1)
        T = rails[0].shape[1]
        name, source, replaces = sources[key]
        k = _kernel(name, source, replaces, err, ms, plain, n_bytes,
                    ops_a_step * n_lanes * T, (n_lanes, T),
                    (n_lanes, F64_CUT), smi, ops_per_s=F64_OPS_PER_S)
        held.setdefault(key, []).append((where, k))
        aligned = _rows_route(*rails)
        equal_on = (f"{n_lanes}x{ALIGNED_CUT} (views of the rows, "
                    f"{'as they lie' if aligned else 'padded'}) and "
                    f"{n_lanes}x{PADDED_CUT} (padded rows)")
        before = next((v for name_, v in F64_BEFORE_MS[key].items()
                       if name_ in where), None)
        route = ("as they lie" if aligned else
                 f"through padded copies ({_copy_ms(*rails):.3f} ms "
                 "of the kernel's time)")
        extra = f"; full rows {route}"
        if before is not None:
            extra += f"; {before:.3f} ms before the redesign"
        print(f"{key} on {where}: lanes {n_lanes} T {T}: bitwise equal to "
              f"its f64 twin on {equal_on}; twin {plain:.1f} ms at "
              f"{n_lanes}x{F64_CUT}; kernel {ms:.3f} ms at full "
              f"{n_lanes}x{T}, {ms * 1e6 / T:.1f} ns a step, {designs[key]}"
              f"{extra}; bound {k['bound_ms']:.3f} ms ({k['bound_by']}) "
              f"[{smi}]")

    def loop_at(where, kind, x, rows, tables, row_of_lane=None):
        twin = afsk_pll if kind == "afsk_pll" else bpsk_costas
        twin_tables = tables[:1] if kind == "afsk_pll" else tables
        L = rows.shape[1]
        R, T = x.shape
        hold("K11", f"{where} ({kind})",
             lambda t: coherent_loop_f64_lanes(kind, t, rows, *tables[:2],
                                               row_of_lane),
             lambda t: twin(t, rows, *twin_tables, row_of_lane), x, L,
             8 * (R * T + L * T + 15 * L + 256 * len(twin_tables)) + 4 * L,
             40 if kind == "afsk_pll" else 45)

    def slicer_at(key, where, x, lp, window, demap=None):
        L, T = x.shape
        if key == "K10":
            kernel = lambda t: binary_slice_f64_lanes(t, lp, window)
            twin = lambda t: binary_slice(t, lp, window)
        else:
            kernel = lambda t: four_level_slice_f64_lanes(t, lp, demap,
                                                          window)
            twin = lambda t: four_level_slice(t, lp, demap, window)
        hold(key, f"{where} window {window}", kernel, twin, x, L,
             8 * (L * T + 2 * L) + 4 * L * -(-T // window),
             15 if key == "K10" else 35)

    def agc_at(where, x, rows):
        L, T = x.shape
        hold("K13", where, lambda t: agc_f64_lanes(t, rows),
             lambda t: agc_follower(t, rows), x, L,
             8 * (2 * L * T + 5 * L), 12)

    def qpsk_at(where, x, rows, tables, row_of_lane=None):
        L = rows.shape[1]
        R, T = x.shape
        hold("K14", f"{where} ({rows.shape[0]} rows)",
             lambda t: qpsk_costas_f64_lanes(t, rows, *tables, row_of_lane),
             lambda t: qpsk_costas(t, rows, *tables, row_of_lane), x, L,
             8 * (R * T + 2 * L * T + rows.shape[0] * L + 512) + 4 * L,
             70 if rows.shape[0] > 12 else 60)

    def mpsk_at(where, re, im, rows, tables, pd, index, row_of_lane=None):
        L = rows.shape[1]
        R, T = re.shape
        hold("K15", where,
             lambda a, b: mpsk_loop_f64_lanes(a, b, rows, *tables, pd, index,
                                              row_of_lane),
             lambda a, b: mpsk_loop(a, b, rows, *tables, pd, index,
                                    row_of_lane), (re, im), L,
             8 * (2 * R * T + 2 * L * T + 12 * L + 512)
             + 4 * (pd.numel() + 2 * L), 50)

    def quad_at(where, i, q, lp, sl, window):
        L, T = i.shape
        args = (lp, sl.demap, sl.state_mask, sl.bits_per_symbol, window)
        hold("K16", f"{where} window {window}",
             lambda a, b: quadrature_slice_f64_lanes(a, b, *args),
             lambda a, b: quadrature_slice(a, b, *args), (i, q), L,
             8 * (2 * L * T + 2 * L) + 4 * L * -(-T // window), 20)

    # the executor's one lane over 60 s of each family's recording
    afsk60 = _whole_segments(expected, audio, len(audio) // (SECONDS // 30),
                             RATE, EXECUTOR_SECONDS)
    lane_cases = {
        "afsk300_pll": (build_chain_spec(float(RATE), _chain_line(
            "AFSK 300 Il2Pc PLL", "afsk_pll")), afsk60[1]),
        "bpsk1200": (psk_chains["bpsk1200_sweep8"][0], _whole_segments(
            *psk_audio["bpsk1200_sweep8"][:3], PSK_RATE,
            EXECUTOR_SECONDS)[1]),
        "fsk4_9600": (fsk_chains["fsk4_9600_sweep8"][0], _whole_segments(
            *fsk_audio["fsk4_9600_sweep8"][:3], FSK4_RATE,
            EXECUTOR_SECONDS)[1]),
        "qpsk2400_costas": (fsk_chains["qpsk_costas2400_sweep8"][0],
                            _whole_segments(
            *fsk_audio["qpsk_costas2400_sweep8"][:3], PSK_RATE,
            EXECUTOR_SECONDS)[1]),
        "mpsk_qpsk2400": (psk_chains["qpsk2400_sweep8"][0], _whole_segments(
            *psk_audio["qpsk2400_sweep8"][:3], PSK_RATE,
            EXECUTOR_SECONDS)[1]),
        "mpsk_bpsk1200": (psk_chains["mpsk_bpsk1200_pair"][0],
                          _whole_segments(
            *psk_audio["mpsk_bpsk1200_pair"][:3], PSK_RATE,
            EXECUTOR_SECONDS)[1]),
    }
    for fam, (chain, wave) in lane_cases.items():
        m, sl = chain.modem, chain.slicer
        params = modems.build_params(m)
        a64 = torch.from_numpy(wave).to(dev).to(F64)
        where = f"the executor's lane ({fam}, {len(wave) / sl.sample_rate:.0f} s)"
        tables = modems.nco_tables(dev, F64)
        if m.kind in ("afsk_pll", "bpsk"):
            x, rows = modems.coherent_loop_inputs(m, params, a64)
            loop_at(where, m.kind, x, rows, tables)
        elif m.kind == "qpsk":
            x, rows = modems.coherent_loop_inputs(m, params, a64)
            qpsk_at(where, x, rows, tables)
        elif m.kind == "mpsk":
            band = fir_valid_nd(a64, params.input_bpf)
            agc_at(where, band[None], modems.agc_rows(params.agc, band))
            re, im, rows, pd, index = modems.mpsk_loop_inputs(m, params,
                                                              a64)
            mpsk_at(where, re, im, rows, tables, pd, index)
        base = modems.demod(m, params, a64)
        lp = slicer_lane_params(sl, dev, F64)
        if sl.kind == "quadrature":
            quad_at(where, base[0][None], base[1][None], lp, sl, 1)
        elif sl.kind == "4level":
            slicer_at("K12", where, base[None], lp, 1, sl.demap)
        else:
            slicer_at("K10", where, base[None], lp, 1)

    # the banks' lanes, at f64
    def bank_frames(chains, wave, mps):
        bank_ = tbank.group_chains(chains, dev, dtype=F64)[0]
        w = torch.from_numpy(wave).to(dev)
        plan_ = tbank.bank_plan(bank_, len(w), max_packet_seconds=mps)
        return bank_, tbank.frame_blocks(w, plan_).to(F64)

    bank_cases = (
        ("pll_sweep8", banks["pll_sweep8"], audio, MAX_PACKET_SECONDS),
        ("bpsk1200_sweep8", psk_chains["bpsk1200_sweep8"],
         psk_audio["bpsk1200_sweep8"][1], psk_audio["bpsk1200_sweep8"][3]),
        ("fsk4_9600_sweep8", fsk_chains["fsk4_9600_sweep8"],
         fsk_audio["fsk4_9600_sweep8"][1], fsk_audio["fsk4_9600_sweep8"][3]),
        *((name, psk_chains[name], psk_audio[name][1], psk_audio[name][3])
          for name in ("qpsk2400_sweep8", "mpsk_bpsk1200_pair")),
        ("qpsk_costas2400_sweep8", fsk_chains["qpsk_costas2400_sweep8"],
         fsk_audio["qpsk_costas2400_sweep8"][1],
         fsk_audio["qpsk_costas2400_sweep8"][3]))
    for name, chains, wave, mps in bank_cases:
        bank_, frames = bank_frames(chains, wave, mps)
        tables = (bank_.params.get("sine_table"),
                  bank_.params.get("cos_table"))
        if bank_.kind in ("afsk_pll", "bpsk"):
            x, rows, rol = tbank.coherent_loop_inputs(bank_.params, frames)
            loop_at(f"{name} ({x.shape[0]} shared rows)", bank_.kind, x,
                    rows, tables, rol)
            del x
        elif bank_.kind == "qpsk":
            x, rows, rol = tbank.coherent_loop_inputs(bank_.params, frames)
            qpsk_at(f"{name} ({x.shape[0]} shared rows)", x, rows, tables,
                    rol)
            del x
        elif bank_.kind == "mpsk":
            lanes, rows = tbank.mpsk_agc_inputs(bank_.params, frames)
            agc_at(f"{name} ({lanes.shape[0]} lanes)", lanes, rows)
            del lanes
            re, im, rows, pd, index, rol = tbank.mpsk_loop_inputs(
                bank_.params, frames)
            mpsk_at(f"{name} ({re.shape[0]} rows)", re, im, rows, tables,
                    pd, index, rol)
            del re, im
        bb = tbank.bank_basebands(bank_, frames)
        del frames
        window = tbank.slicer_window(bank_)
        if isinstance(bb, tuple):
            C, B, L2 = bb[0].shape
            quad_at(name, *(r.reshape(C * B, L2).contiguous() for r in bb),
                    tbank.slicer_lane_params(bank_, B),
                    bank_.specs[0].slicer, window)
        else:
            C, B, L2 = bb.shape
            lp = tbank.slicer_lane_params(bank_, B)
            key = "K12" if bank_.slicer_kind == "4level" else "K10"
            slicer_at(key, name, bb.reshape(C * B, L2), lp, window,
                      bank_.specs[0].slicer.demap if key == "K12" else None)
        del bb
    _phase(25, "K10-K16 == f64 twins", t0)

    # 26. the f64 mode end to end: the executor (its default route) and
    # run_plan_banked at f64, with the f32 runs of the same plans beside
    t0 = time.time()
    f32_keys = {f"K{i}" for i in range(1, 9)}
    f64_launches: dict = {}

    def f64_run(what, fn, need):
        """One f64 run with the counters set to 0 before and read after:
        fails unless it launched each of ``need`` and no f32 loop or
        slicer kernel (K1-K8).  Returns the result, the wall, the peak
        device memory, the launches and the padded-row copies made for the
        staged K10-K16 (``_ext.lane_rows.copies``)."""
        zero_counts()
        _ext.lane_rows.copies = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        result = fn()
        torch.cuda.synchronize()
        wall = time.time() - t1
        launched = read_counts()
        copies = _ext.lane_rows.copies
        if f32_keys & set(launched) or not set(need) <= set(launched):
            raise AssertionError(f"{what} at f64 launched {launched}, "
                                 f"expected {sorted(need)} and no K1-K8")
        for k, v in launched.items():
            f64_launches[k] = f64_launches.get(k, 0) + v
        return (result, wall, torch.cuda.max_memory_allocated(), launched,
                copies)

    psk60 = _whole_segments(*psk_audio["bpsk1200_sweep8"][:3], PSK_RATE,
                            EXECUTOR_SECONDS)
    fsk60 = _whole_segments(*fsk_audio["fsk9600_sweep8"][:3], FSK_RATE,
                            EXECUTOR_SECONDS)
    fsk4_60 = _whole_segments(*fsk_audio["fsk4_9600_sweep8"][:3], FSK4_RATE,
                              EXECUTOR_SECONDS)
    pll_pair_lines = (_chain_line("AFSK 300 Il2Pc PLL", "afsk_pll"),
                      _chain_line("AFSK 300 Il2Pc PLL inverted", "afsk_pll",
                                  "yes"))
    exec_cases = {
        "afsk_300_pll": ([build_chain_spec(float(RATE), ln)
                          for ln in pll_pair_lines], RATE, afsk60,
                         {"K10", "K11"}),
        "afsk300": ([build_chain_spec(float(RATE), _chain_line(
            "AFSK 300 Il2Pc Correlator", "afsk"))], RATE, afsk60, {"K10"}),
        "bpsk1200": ([psk_chains["bpsk1200_sweep8"][0]], PSK_RATE, psk60,
                     {"K10", "K11"}),
        "fsk9600": ([fsk_chains["fsk9600_sweep8"][0]], FSK_RATE, fsk60,
                    {"K10"}),
        "fsk4_9600": ([fsk_chains["fsk4_9600_sweep8"][0]], FSK4_RATE,
                      fsk4_60, {"K12"}),
        "qpsk2400_costas": ([fsk_chains["qpsk_costas2400_sweep8"][0]],
                            PSK_RATE, _whole_segments(
            *fsk_audio["qpsk_costas2400_sweep8"][:3], PSK_RATE,
            EXECUTOR_SECONDS), {"K14", "K16"}),
        "mpsk_qpsk2400": ([psk_chains["qpsk2400_sweep8"][0]], PSK_RATE,
                          _whole_segments(*psk_audio["qpsk2400_sweep8"][:3],
                                          PSK_RATE, EXECUTOR_SECONDS),
                          {"K13", "K15", "K16"}),
        "mpsk_bpsk1200": ([psk_chains["mpsk_bpsk1200_pair"][0]], PSK_RATE,
                          _whole_segments(
            *psk_audio["mpsk_bpsk1200_pair"][:3], PSK_RATE,
            EXECUTOR_SECONDS), {"K13", "K15", "K16"}),
    }
    walls = {}
    for name, (chains, rate, (sent, wave), need) in exec_cases.items():
        plan_ = RunPlan(chains=tuple(chains), reports=reports)

        def run64():
            return executor.run_plan(plan_, wave, rate, resilient=False,
                                     device=dev, dtype=F64)

        run64()  # the kernels' first launches
        result, wall, peak, launched, copies = f64_run(name, run64,
                                                        need)
        _check_bank(f"{name} (executor, f64)", result, sent)
        t1 = time.time()
        r32 = executor.run_plan(plan_, wave, rate, resilient=False,
                                device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        wall32 = time.time() - t1
        a, b = set(_packet_keys(result)), set(_packet_keys(r32))
        walls[f"executor {name}"] = (wall, wall32)
        print(f"f64 executor {name}: {len(chains)} chain(s) x "
              f"{len(wave) / rate:.0f} s, {len(sent)} frames decoded, 0 "
              f"rejected; launches {launched}, padded-row copies for the "
              f"staged K10-K16 {copies}; wall {wall:.3f} s at f64, "
              f"{wall32:.3f} s at f32; packets differing between f64 and "
              f"f32: {len(a ^ b)} of {len(a | b)}; peak device memory "
              f"{peak / 2**30:.2f} GiB [{smi}]")
    base = build_chain_spec(float(RATE), _chain_line(
        "AFSK 300 Il2Pc Correlator", "afsk"))
    # each bank: (chains, payloads, audio, rate, max_packet_seconds)
    afsk_case = (expected, audio, RATE, MAX_PACKET_SECONDS)
    bank_plans = {
        "pll_pair": (banks["pll_pair"], *afsk_case),
        "pll_sweep8": (banks["pll_sweep8"], *afsk_case),
        "space_gain_sweep8": ([_variant(base, f"g{i}", space_gain=g)
                               for i, g in enumerate(F64_SWEEP_GAINS)],
                              *afsk_case),
        **{name: (psk_chains[name], psk_audio[name][0], psk_audio[name][1],
                  PSK_RATE, psk_audio[name][3])
           for name in ("qpsk2400_sweep8", "mpsk_bpsk1200_pair")},
        "qpsk_costas2400_sweep8": (
            fsk_chains["qpsk_costas2400_sweep8"],
            fsk_audio["qpsk_costas2400_sweep8"][0],
            fsk_audio["qpsk_costas2400_sweep8"][1], PSK_RATE,
            fsk_audio["qpsk_costas2400_sweep8"][3]),
    }
    need_of = {"afsk": {"K10"}, "afsk_pll": {"K10", "K11"},
               "qpsk": {"K14", "K16"}, "mpsk": {"K13", "K15", "K16"}}
    for name, (chains, sent, wave, rate, mps) in bank_plans.items():
        plan_ = RunPlan(chains=tuple(chains), reports=reports)
        (bank_,) = tbank.group_chains(chains, "cpu", dtype=F64)
        if "space_scale" in bank_.params:
            raise AssertionError(f"{name}: an f64 bank with a scale row")
        need = need_of[bank_.kind]

        def run64(dtype=F64):
            return tbank.run_plan_banked(
                plan_, wave, rate, max_packet_seconds=mps,
                resilient=False, device=dev, dtype=dtype)

        def warm_walls(dtype):
            """Walls of WARM_RUNS - 1 more warm runs at ``dtype``."""
            out = []
            for _ in range(WARM_RUNS - 1):
                t1 = time.time()
                run64(dtype)
                torch.cuda.synchronize()
                out.append(time.time() - t1)
            return out

        run64()  # budgets and first launches
        result, wall, peak, launched, copies = f64_run(name, run64,
                                                        need)
        _check_bank(f"{name} (banked, f64)", result, sent)
        walls64 = [wall, *warm_walls(F64)]
        run64(torch.float32)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        r32 = run64(torch.float32)
        torch.cuda.synchronize()
        wall32 = time.time() - t1
        peak32 = torch.cuda.max_memory_allocated()
        walls32 = [wall32, *warm_walls(torch.float32)]
        a, b = set(_packet_keys(result)), set(_packet_keys(r32))
        pa, pb = ({k[:2] for k in keys} for keys in (a, b))
        walls[f"banked {name}"] = tuple(sorted(w)[len(w) // 2]
                                        for w in (walls64, walls32))
        plan_b = tbank.bank_plan(bank_, len(wave), max_packet_seconds=mps)
        print(f"f64 run_plan_banked {name}: {len(chains)} chains x "
              f"{len(wave) / rate:.0f} s ({plan_b.n_blocks} blocks of "
              f"{plan_b.block_input_len} samples at f64, "
              f"{-(-plan_b.n_blocks // tbank.blocks_per_group(bank_, plan_b))}"
              f" group(s)), {len(sent)} "
              f"frames decoded, 0 rejected; launches {launched}, padded-row "
              f"copies for the staged K10-K16 {copies}; warm walls of {WARM_RUNS}, "
              f"min / median / max, {_spread(walls64)} s at f64, "
              f"{_spread(walls32)} s at f32; packets "
              f"differing between f64 and f32: {len(a ^ b)} of "
              f"{len(a | b)} by (chain, bytes, stream address), "
              f"{len(pa ^ pb)} of {len(pa | pb)} by (chain, bytes) (where "
              f"the f64 bank's blocks are shorter, its lane budget counting "
              f"8 bytes a sample, an address moves with its block's start); "
              f"peak device memory {peak / 2**30:.2f} GiB at "
              f"f64, {peak32 / 2**30:.2f} GiB at f32 [{smi}]")
    print(f"f64 mode: launches {f64_launches}; walls (f64, f32) s, "
          f"medians of {WARM_RUNS} for the banks "
          f"{ {k: (round(a, 3), round(b, 3)) for k, (a, b) in walls.items()} }")
    _phase(26, "f64 mode end to end (executor, run_plan_banked)", t0)

    # 27. the CLI under PYMODEM_TPU_TORCH_X64 on the card against the same
    # decode on the CPU twins, and the synthesizer's round trip
    t0 = time.time()
    import io

    from pymodem_tpu_torch import cli
    from pymodem_tpu_torch.synth import fixtures as fx
    from pymodem_tpu_torch.synth import modulate as mod

    tmp = tempfile.mkdtemp()
    cfg = os.path.join(tmp, "afsk_300_pll.json")
    with open(cfg, "w") as fh:
        for line in (*pll_pair_lines, {"object_name": "report",
                                       "object_type": "report",
                                       "options": {"style":
                                                   "decoded_headers"}}):
            fh.write(json.dumps(line) + "\n")
    # short audio (the CPU twins step in Python): 2 frames of 10 bytes
    sent, short = fx.synthesize_for_chain(
        build_chain_spec(float(RATE), pll_pair_lines[0]), float(RATE),
        np.random.default_rng(SEED), n_frames=2, size=10, gap_bits=300)
    wav = os.path.join(tmp, "pll.wav")
    write_wav(wav, RATE, mod.to_int16(short))
    card = _cli_report(cfg, wav, {"PYMODEM_TPU_TORCH_X64": "1",
                                  "PYMODEM_TPU_TORCH_DEVICE": "cuda"})
    # the same decode through the CLI's run_decode on the CPU twins, in
    # this process
    saved = {k: os.environ.get(k) for k in ("PYMODEM_TPU_TORCH_X64",
                                            "PYMODEM_TPU_TORCH_DEVICE",
                                            "PYMODEM_TPU_TORCH_RUNTIME")}
    os.environ.update(PYMODEM_TPU_TORCH_X64="1",
                      PYMODEM_TPU_TORCH_DEVICE="cpu")
    os.environ.pop("PYMODEM_TPU_TORCH_RUNTIME", None)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.run_decode(cfg, wav)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = buf.getvalue()
    cpu = out[out.index("Generating"):out.index("Elapsed time")]
    want = f"Unique, valid packets:  {len(sent)}\n"
    if code != 0 or card != cpu or want not in card:
        raise AssertionError(f"f64 CLI on the card:\n{card}\non the CPU "
                             f"twins (exit {code}):\n{cpu}")
    print(f"f64 CLI subprocess (PYMODEM_TPU_TORCH_X64=1, the sequential "
          f"executor) on {len(short) / RATE:.1f} s of the PLL pair's "
          f"config: exit 0, report equal to the same decode on the CPU "
          f"twins, {len(sent)} of {len(sent)} frames")
    out_wav = os.path.join(tmp, "synth.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "pymodem_tpu_torch.synth", cfg, out_wav,
         "--seconds", "20", "--seed", str(SEED)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"synth exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr[-3000:]}")
    n_frames = proc.stdout.count("  frame ")
    want = f"Unique, valid packets:  {n_frames}\n"
    text = _cli_report(cfg, out_wav, {"PYMODEM_TPU_TORCH_DEVICE": "cuda"})
    if not n_frames or want not in text:
        raise AssertionError(f"synth round trip: expected {want!r}:\n"
                             f"{text}")
    print(f"synth round trip: python -m pymodem_tpu_torch.synth wrote "
          f"{n_frames} frames for the PLL pair's config; the CLI on the "
          f"card decoded all {n_frames}")
    _phase(27, "f64 CLI == CPU twins; synth round trip", t0)

    # each kernel's entry at its main bank's shape, the others beside it
    entries = {}
    for key, main_where in (("K10", "pll_sweep8"), ("K11", "pll_sweep8"),
                            ("K12", "fsk4_9600_sweep8"),
                            ("K13", "qpsk2400_sweep8"),
                            ("K14", "qpsk_costas2400_sweep8"),
                            ("K15", "qpsk2400_sweep8"),
                            ("K16", "qpsk2400_sweep8")):
        main = next(k for where, k in held[key]
                    if where.startswith(main_where))
        entries[key] = dict(main, launches=f64_launches.get(key, 0),
                            other_shapes={
            where: {f: k[f] for f in ("shape", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms")}
            for where, k in held[key] if k is not main})
    return entries, f64_launches


def _f64_front_doors(dev, smi, banks, afsk, wrappers) -> dict:
    """Phase 28, the float64 mode through the front doors that take more
    than one recording, and the stream: ``run_banked_many(depth=1)`` over
    three 60 s recordings of ``pll_pair`` against three solo f64
    ``run_banked`` calls, with 0 syncs in a warm submit;
    ``run_banked_files`` on the space-gain sweep (a correlator bank) and
    ``run_plans_banked_pipelined`` over two configs, each against its solo
    calls; ``StreamDecoder`` at f64 over 600 s of ``pll_sweep8`` in 120 s
    chunks against the one-shot f64 run by the JAX package's rule, a
    ``state()``/``restore()`` round trip, its peak memory and
    chain-Msamples/s beside the f32 stream's; the CLI's batch route under
    PYMODEM_TPU_TORCH_X64 with the banked runtime against one-at-a-time
    runs.  ``wrappers``: every kernel wrapper by key (K1-K16).  Returns
    the launches of its runs, which launch none of K1-K8."""
    import io
    import re

    import numpy as np
    import torch

    from pymodem_tpu_torch import cli
    from pymodem_tpu_torch.config import ReportSpec, RunPlan, build_chain_spec
    from pymodem_tpu_torch.runtime import bank as tbank
    from pymodem_tpu_torch.runtime.stream import StreamDecoder
    from pymodem_tpu_torch.wav_io import write_wav

    F64 = torch.float64
    expected, audio = afsk
    reports = (ReportSpec("decoded", style="decoded_headers"),)
    f32_keys = {f"K{i}" for i in range(1, 9)}
    launches: dict = {}

    def counted(what, fn, need):
        """``fn()`` with the counters set to 0 before and read after:
        fails unless it launched each of ``need`` and none of K1-K8."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in wrappers.items() if w.launches}
        if f32_keys & set(got) or not set(need) <= set(got):
            raise AssertionError(f"{what} at f64 launched {got}, expected "
                                 f"{sorted(need)} and no K1-K8")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return out

    def timed(fn):
        t1 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t1

    t0 = time.time()
    pair = banks["pll_pair"]
    sent60, wave60 = _whole_segments(expected, audio,
                                     len(audio) // (SECONDS // 30), RATE,
                                     EXECUTOR_SECONDS)
    g = np.random.default_rng(SEED + 28)
    recs = [wave60] + [np.clip(wave60 + g.normal(0.0, NOISE_STD,
                                                 len(wave60)),
                               -32768, 32767).astype(np.int16)
                       for _ in range(2)]
    kw = dict(max_packet_seconds=MAX_PACKET_SECONDS, device=dev, dtype=F64)
    # run_banked_many against three solo calls; a warm submit's syncs
    tbank.run_banked_many(pair, recs, depth=1, **kw)  # budgets, launches
    many, many_wall = timed(lambda: counted(
        "run_banked_many", lambda: tbank.run_banked_many(pair, recs, depth=1,
                                                         **kw),
        {"K10", "K11"}))
    solo, solo_wall = timed(lambda: [tbank.run_banked(pair, r, **kw)
                                     for r in recs])
    for i, (got, want) in enumerate(zip(many, solo)):
        _same_packets(f"f64 pll_pair recording {i}", got, want,
                      ("run_banked_many", "solo run_banked"))
        decoded = [bytes(p.data[16:-2]) for p in max(got.values(), key=len)]
        if decoded != sent60:
            raise AssertionError(f"f64 run_banked_many recording {i}: "
                                 f"{len(decoded)} of {len(sent60)} frames")
    syncs = _submit_syncs(tbank, pair, recs[0], kw)
    if syncs:
        raise AssertionError(f"a warm f64 submit synchronised the stream: "
                             f"{dict(syncs)}")
    print(f"f64 run_banked_many(depth=1) over {len(recs)} x "
          f"{len(wave60) / RATE:.0f} s of pll_pair (two with noise): packets "
          f"equal to {len(recs)} solo f64 run_banked calls, every frame "
          f"({len(sent60)} a recording); walls {many_wall:.3f} s pipelined, "
          f"{solo_wall:.3f} s solo; stream synchronisations in one warm "
          f"submit: 0 [{smi}]")

    # run_banked_files on a correlator bank, each file against its solo run
    base = build_chain_spec(float(RATE), _chain_line(
        "AFSK 300 Il2Pc Correlator", "afsk"))
    sweep = [_variant(base, f"g{i}", space_gain=gain)
             for i, gain in enumerate(F64_SWEEP_GAINS)]
    files = [audio[:60 * RATE], audio[60 * RATE: 90 * RATE],
             audio[90 * RATE: 105 * RATE]]
    tbank.run_banked_files(sweep, files, **kw)
    batched, files_wall = timed(lambda: counted(
        "run_banked_files", lambda: tbank.run_banked_files(sweep, files,
                                                           **kw), {"K10"}))
    for i, (f, got) in enumerate(zip(files, batched)):
        _same_packets(f"f64 run_banked_files file {i}", got,
                      tbank.run_banked(sweep, f, **kw),
                      ("run_banked_files", "solo run_banked"))
    print(f"f64 run_banked_files over 60, 30 and 15 s files of "
          f"space_gain_sweep8 (8 chains): each file's packets equal to its "
          f"solo f64 run_banked; wall {files_wall:.3f} s [{smi}]")

    # run_plans_banked_pipelined over two configs against per-job runs
    pkw = dict(max_packet_seconds=MAX_PACKET_SECONDS, device=dev, dtype=F64)
    jobs = [(RunPlan(chains=tuple(pair), reports=reports), recs[0], RATE),
            (RunPlan(chains=tuple(sweep), reports=reports), recs[1], RATE),
            (RunPlan(chains=tuple(pair), reports=reports), recs[2], RATE)]
    tbank.run_plans_banked_pipelined(jobs, depth=1, **pkw)
    piped, piped_wall = timed(lambda: counted(
        "run_plans_banked_pipelined",
        lambda: tbank.run_plans_banked_pipelined(jobs, depth=1, **pkw),
        {"K10", "K11"}))
    per_job, job_wall = timed(lambda: [
        tbank.run_plan_banked(p, a, r, resilient=False, **pkw)
        for p, a, r in jobs])
    for i, (got, want) in enumerate(zip(piped, per_job)):
        if got.reports != want.reports:
            raise AssertionError(f"f64 run_plans_banked_pipelined job {i}: "
                                 "reports differ from run_plan_banked's")
    print(f"f64 run_plans_banked_pipelined over {len(jobs)} jobs of two "
          f"configs (pll_pair, space_gain_sweep8; 60 s each): reports equal "
          f"to per-job f64 run_plan_banked; walls {piped_wall:.3f} s "
          f"pipelined, {job_wall:.3f} s per job [{smi}]")
    _phase(28, "f64 run_banked_many, run_banked_files, pipelined plans",
           t0)

    # StreamDecoder at f64 over 600 s of pll_sweep8 in 120 s chunks
    t0 = time.time()
    pll = banks["pll_sweep8"]
    skw = dict(max_packet_seconds=MAX_PACKET_SECONDS, device=dev)
    chunk = STREAM_CHUNK_SECONDS * RATE
    oneshot = tbank.run_banked(pll, audio, dtype=F64, **skw)
    _stream(pll, audio, RATE, chunk, dtype=F64, **skw)  # budgets
    torch.cuda.reset_peak_memory_stats()
    (dec, out), wall64 = timed(lambda: counted(
        "StreamDecoder", lambda: _stream(pll, audio, RATE, chunk, dtype=F64,
                                         **skw), {"K10", "K11"}))
    peak64 = torch.cuda.max_memory_allocated()
    if dec.dtype != F64 or any(st.bank.dtype != F64 for st in dec._banks):
        raise AssertionError("the f64 stream's banks are not float64")
    by = _by_chain(pll, out)
    _check_bank("f64 pll_sweep8 stream", tbank._finish_plan(
        RunPlan(chains=tuple(pll), reports=reports), by, RATE), expected)
    _same_by_jax_rule("f64 pll_sweep8 stream", by, oneshot, RATE,
                      pll[0].slicer.symbol_rate)
    chunks = [audio[s: s + chunk] for s in range(0, len(audio), chunk)]
    half = len(chunks) // 2
    first = StreamDecoder(pll, RATE, dtype=F64, **skw)
    got = []
    for c in chunks[:half]:
        got += first.feed(c)
    blob = json.dumps(first.state())
    del first
    resumed = StreamDecoder(pll, RATE, dtype=F64, **skw)
    resumed.restore(json.loads(blob))
    for c in chunks[half:]:
        got += resumed.feed(c)
    got += resumed.flush()
    _same_packets("f64 pll_sweep8 resumed from a checkpoint",
                  _by_chain(pll, got), by, ("resumed stream", "uninterrupted"))
    _stream(pll, audio, RATE, chunk, **skw)  # f32 budgets
    torch.cuda.reset_peak_memory_stats()
    _, wall32 = timed(lambda: _stream(pll, audio, RATE, chunk, **skw))
    peak32 = torch.cuda.max_memory_allocated()
    samples = len(pll) * len(audio)
    print(f"f64 stream pll_sweep8 over {SECONDS} s in "
          f"{STREAM_CHUNK_SECONDS} s chunks: every frame ({len(expected)}), "
          f"0 rejected, the one-shot f64 run's payloads chain for chain with "
          f"addresses within rate/40 + 9 symbol periods; a checkpoint after "
          f"{half} of {len(chunks)} chunks ({len(blob)} bytes of JSON) "
          f"restored: the uninterrupted stream's packets; warm wall "
          f"{wall64:.3f} s = {samples / wall64 / 1e6:.1f} chain-Msamples/s "
          f"at f64, {wall32:.3f} s = {samples / wall32 / 1e6:.1f} at f32; "
          f"peak device memory {peak64 / 2**30:.3f} GiB at f64, "
          f"{peak32 / 2**30:.3f} GiB at f32 [{smi}]")
    _phase(28, "f64 stream: pll_sweep8, a checkpoint", t0)

    # the CLI's batch route under the mode with the banked runtime
    t0 = time.time()
    tmp = tempfile.mkdtemp()
    requests = []
    for name, lines in (
            ("afsk_300_pll", (_chain_line("AFSK 300 Il2Pc PLL", "afsk_pll"),
                              _chain_line("AFSK 300 Il2Pc PLL inverted",
                                          "afsk_pll", "yes"))),
            ("afsk_300", (_chain_line("AFSK 300 Il2Pc Correlator",
                                      "afsk"),))):
        cfg = os.path.join(tmp, f"{name}.json")
        with open(cfg, "w") as fh:
            for line in (*lines, {"object_name": "report",
                                  "object_type": "report",
                                  "options": {"style": "decoded_headers"}}):
                fh.write(json.dumps(line) + "\n")
        for i, rec in enumerate(recs[:2]):
            wav = os.path.join(tmp, f"{name}_{i}.wav")
            write_wav(wav, RATE, rec)
            requests.append((cfg, wav))
    env = {"PYMODEM_TPU_TORCH_X64": "1", "PYMODEM_TPU_TORCH_RUNTIME": "banked",
           "PYMODEM_TPU_TORCH_DEVICE": "cuda"}
    saved = {k: os.environ.get(k) for k in env}
    pipelined = tbank.run_plans_banked_pipelined
    calls = []

    def spy(jobs_, **kw_):
        calls.append(len(jobs_))
        return pipelined(jobs_, **kw_)

    os.environ.update(env)
    tbank.run_plans_banked_pipelined = spy
    try:
        cli.run_decode_batch(requests)  # budgets
        calls.clear()
        batch, batch_wall = timed(lambda: counted(
            "the CLI's batch route", lambda: cli.run_decode_batch(requests),
            {"K10", "K11"}))
        one = []
        t1 = time.time()
        for cfg, wav in requests:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = cli.run_decode(cfg, wav)
            one.append((code, buf.getvalue()))
        one_wall = time.time() - t1
    finally:
        tbank.run_plans_banked_pipelined = pipelined
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def strip(text):
        return re.sub(r"Elapsed time.*\n?", "", text)

    if calls != [len(requests)] or [(c, strip(o)) for c, o in batch] != \
            [(c, strip(o)) for c, o in one]:
        raise AssertionError(f"the f64 CLI batch: pipelined calls {calls}; "
                             f"outputs equal to one-at-a-time runs: "
                             f"{batch == one}")
    for code, text in batch:
        _no_retry("f64 CLI batch", text)
        if code != 0 or f"Unique, valid packets:  {len(sent60)}\n" \
                not in text:
            raise AssertionError(f"f64 CLI batch request: exit {code}\n"
                                 f"{text[-2000:]}")
    print(f"f64 CLI batch (PYMODEM_TPU_TORCH_X64=1, "
          f"PYMODEM_TPU_TORCH_RUNTIME=banked): {len(requests)} requests of "
          f"two configs through one run_plans_banked_pipelined call, outputs "
          f"equal to one-at-a-time runs, every frame; walls {batch_wall:.3f} "
          f"s batched, {one_wall:.3f} s one at a time [{smi}]")
    print(f"phase 28 launches {launches}")
    _phase(28, "f64 CLI batch route", t0)
    return launches


def _all_wrappers() -> dict:
    """Every kernel wrapper by key (K1-K16); each counts its launches in
    its ``launches`` attribute."""
    from pymodem_tpu_torch.codecs.ax25_device import ax25_deframe_rows
    from pymodem_tpu_torch.dsp.agc import agc_f64_lanes, agc_lanes
    from pymodem_tpu_torch.dsp.loops import (
        afsk_pll_lanes,
        bpsk_costas_lanes,
        coherent_loop_f64_lanes,
        mpsk_loop_f64_lanes,
        mpsk_loop_lanes,
        qpsk_costas_f64_lanes,
        qpsk_costas_lanes,
    )
    from pymodem_tpu_torch.ops.slicers import (
        binary_slice_f64_lanes,
        binary_slice_lanes,
        four_level_slice_f64_lanes,
        four_level_slice_lanes,
        quadrature_slice_f64_lanes,
        quadrature_slice_lanes,
    )

    return {
        "K1": binary_slice_lanes, "K2": afsk_pll_lanes,
        "K3": bpsk_costas_lanes, "K4": agc_lanes, "K5": qpsk_costas_lanes,
        "K6": mpsk_loop_lanes, "K7": quadrature_slice_lanes,
        "K8": four_level_slice_lanes, "K9": ax25_deframe_rows,
        "K10": binary_slice_f64_lanes, "K11": coherent_loop_f64_lanes,
        "K12": four_level_slice_f64_lanes, "K13": agc_f64_lanes,
        "K14": qpsk_costas_f64_lanes, "K15": mpsk_loop_f64_lanes,
        "K16": quadrature_slice_f64_lanes}


# phases 29-30: the banks of the sharded runtime, and the kernels each
# must launch on every shard
SHARDED_KERNELS = {
    "sweep64": {"K1"}, "pll_sweep8": {"K1", "K2"},
    "qpsk2400_sweep8": {"K4", "K6", "K7"}, "pll_pair_f64": {"K10", "K11"},
    "dryrun_mixed": {"K1", "K9"}}


def _sharded_case(name):
    """(chains, audio, run_banked keywords) of a phase 29-30 bank, made
    from SEED, so that a spawned rank makes the same: the AFSK path's 600
    s for ``sweep64`` and ``pll_sweep8``, the PSK path's for
    ``qpsk2400_sweep8``, 60 s of whole segments of the AFSK path's
    recording for the PLL pair at float64, and the sharded runtime's dry
    run for its mixed IL2P/AX.25 bank."""
    import torch

    from pymodem_tpu_torch.runtime import sharded

    if name == "dryrun_mixed":
        chains, audio = sharded.dryrun_case()
        kw = {k: v for k, v in sharded.DRYRUN_KW.items() if k != "codec"}
        return chains, audio, kw
    if name == "qpsk2400_sweep8":
        chains = _psk_banks()[name]
        _, audio, _, mps = _family_audio(chains[0], PSK_RATE)
        return chains, audio, dict(max_packet_seconds=mps)
    expected, audio = _audio()
    kw = dict(max_packet_seconds=MAX_PACKET_SECONDS)
    if name == "pll_pair_f64":
        _, audio = _whole_segments(expected, audio,
                                   len(audio) // (SECONDS // 30), RATE,
                                   EXECUTOR_SECONDS)
        return _banks()["pll_pair"], audio, dict(kw, dtype=torch.float64)
    return _banks()[name], audio, kw


def _sharded_rank(n_chain: int, n_time: int, names) -> dict:
    """Phases 29-30 on one rank (of a spawned world, or this process's
    own): on a (n_chain, n_time) mesh, each bank of ``names`` decoded cold
    (its budgets) and then warm, the warm call with the launch counters
    set to 0 before it and read after, and ``profiling`` counting it,
    then SHARDED_WARM_RUNS - 1 more warm calls.  Returns per bank the
    counted call's packets (address, bytes), counts (its frame samples
    uploaded among them), launches and peak device memory, the bank's
    block plans, and the warm walls in call order."""
    import torch

    from pymodem_tpu_torch import profiling
    from pymodem_tpu_torch.runtime import bank as tbank
    from pymodem_tpu_torch.runtime import sharded

    mesh = sharded.make_mesh(n_chain, n_time)
    wrappers = _all_wrappers()
    out = {}
    for name in names:
        chains, audio, kw = _sharded_case(name)
        sharded.run_banked_sharded(chains, audio, mesh, **kw)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        profiling.enable(True)
        walls = []
        t1 = time.time()
        try:
            got = sharded.run_banked_sharded(chains, audio, mesh, **kw)
            torch.cuda.synchronize()
        finally:
            profiling.enable(False)
        walls.append(time.time() - t1)
        counts = profiling.counts()
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        for _ in range(SHARDED_WARM_RUNS - 1):
            t1 = time.time()
            sharded.run_banked_sharded(chains, audio, mesh, **kw)
            torch.cuda.synchronize()
            walls.append(time.time() - t1)
        plans = [tbank.bank_plan(
            b, len(audio), kw.get("block_seconds", "auto"),
            kw.get("overlap_seconds", "auto"), kw.get("max_packet_seconds"))
            for b in tbank.group_chains(chains, "cpu", kw.get("dtype"))]
        out[name] = dict(
            packets=sharded.packet_rows(got),
            walls=walls,
            counts=counts,
            launches=launches,
            peak=torch.cuda.max_memory_allocated(),
            plans=plans,
            n_audio=len(audio))
    return out


def _spread(walls) -> str:
    """'min / median / max' of warm walls, in seconds."""
    w = sorted(walls)
    return f"{w[0]:.3f} / {w[len(w) // 2]:.3f} / {w[-1]:.3f}"


def _check_sharded(what, outs, n_time, want, subgroups, smi) -> dict:
    """Hold every rank's warm run of each bank (``_sharded_rank``) against
    ``run_banked`` on the same card, by (address, bytes): every rank's
    packets equal, one packed gather per codec sub-group and no sizing,
    each kernel of the bank's family launched and no block on the host
    FSM, each rank's uploaded frames (the ``sharded_upload_samples``
    count) its blocks' rows, within n_audio / n_time + blocks per shard x
    (overlap + trim) + block_len samples.  Prints each bank's warm walls,
    min / median / max, a call's wall the slower rank's, beside
    ``run_banked``'s (``want``: {bank: (packets, its warm walls)}), and
    peak memory by rank; returns the launches of every rank, summed."""
    from pymodem_tpu_torch.runtime import sharded

    launches: dict = {}
    for name, (rows, base_walls) in want.items():
        runs = [o[name] for o in outs]
        for rank, run in enumerate(runs):
            if run["packets"] != rows:
                for chain in sorted(set(rows) | set(run["packets"])):
                    a = set(run["packets"].get(chain, []))
                    b = set(rows.get(chain, []))
                    if a != b:
                        print(f"  {what} {name} {chain}: sharded only "
                              f"{sorted(a - b)[:3]}, run_banked only "
                              f"{sorted(b - a)[:3]}")
                raise AssertionError(f"{what} {name}: rank {rank}'s packets "
                                     f"differ from run_banked's")
            c = run["counts"]
            if (c.get("sharded_codec_transfer", 0) != subgroups[name]
                    or c.get("sharded_codec_sizing", 0)
                    or c.get("sharded_candidate_budget", 0)
                    or c.get("host_codec", 0)):
                raise AssertionError(f"{what} {name} rank {rank}: warm call "
                                     f"counts {c}, expected "
                                     f"{subgroups[name]} gathers")
            missed = SHARDED_KERNELS[name] - set(run["launches"])
            if missed:
                raise AssertionError(f"{what} {name} rank {rank} launched no "
                                     f"{sorted(missed)}: {run['launches']}")
            uploaded = c.get("sharded_upload_samples", 0)
            rows_of = sum(sharded.blocks_per_shard(p, n_time)
                          * p.block_input_len for p in run["plans"])
            bound = sum(sharded.upload_bound(p, n_time)
                        for p in run["plans"])
            if uploaded != rows_of or uploaded > bound:
                raise AssertionError(f"{what} {name} rank {rank}: uploaded "
                                     f"{uploaded} frame samples, its blocks' "
                                     f"rows {rows_of}, bound {bound}")
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
        n_packets = sum(len(v) for v in rows.values())
        walls = [max(w) for w in zip(*(r["walls"] for r in runs))]
        print(f"{what} {name}: {n_packets} packets on every rank, equal to "
              f"run_banked's; warm walls of {SHARDED_WARM_RUNS}, min / "
              f"median / max, {_spread(walls)} s (run_banked "
              f"{_spread(base_walls)} s); gathers {subgroups[name]}, sizing "
              f"0; AGC all-reduces "
              f"{runs[0]['counts'].get('sharded_agc_normal', 0)}; launches "
              f"by rank {[r['launches'] for r in runs]}; frame samples a "
              f"rank {runs[0]['counts'].get('sharded_upload_samples')} of "
              f"{runs[0]['n_audio']} (bound "
              f"{sum(sharded.upload_bound(p, n_time) for p in runs[0]['plans'])}"
              f"); peak device memory by rank "
              f"{[round(r['peak'] / 2**30, 3) for r in runs]} GiB [{smi}]")
    return launches


def _sharded_phases(dev, smi) -> dict:
    """Phases 29-30, the sharded runtime (``runtime/sharded.py``) against
    ``run_banked`` on the same card: 29 on one rank (this process, NCCL,
    mesh (1, 1)); 30 on two ranks sharing the card over gloo, spawned by
    the port's launcher (the chain axis, mesh (2, 1): ``sweep64`` and the
    mixed IL2P/AX.25 bank; the time axis with the AGC all-reduce, mesh
    (1, 2): ``pll_sweep8``, ``qpsk2400_sweep8`` and the PLL pair at
    float64), then the dry run at 2 ranks.  Returns the launches of the
    sharded runs, summed over ranks."""
    import torch
    import torch.distributed as dist

    from pymodem_tpu_torch.runtime import bank as tbank
    from pymodem_tpu_torch.runtime import sharded

    def baseline(names):
        """{bank: (run_banked's packets, its SHARDED_WARM_RUNS warm
        walls)} and {bank: codec sub-groups}."""
        want, subgroups = {}, {}
        for name in names:
            chains, audio, kw = _sharded_case(name)
            tbank.run_banked(chains, audio, device=dev, **kw)
            walls = []
            for _ in range(SHARDED_WARM_RUNS):
                t1 = time.time()
                rows = sharded.packet_rows(tbank.run_banked(
                    chains, audio, device=dev, **kw))
                torch.cuda.synchronize()
                walls.append(time.time() - t1)
            want[name] = (rows, walls)
            subgroups[name] = sum(
                len(tbank._codec_subgroups(b)) for b in
                tbank.group_chains(chains, "cpu", kw.get("dtype")))
        return want, subgroups

    launches: dict = {}

    def add(more):
        for k, v in more.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.time()
    names = ("sweep64", "pll_sweep8")
    want, subgroups = baseline(names)
    tmp = tempfile.mkdtemp()
    dist.init_process_group(sharded.backend_for(1, "cuda"),
                            init_method="file://" + os.path.join(tmp, "store"),
                            world_size=1, rank=0, timeout=sharded.TIMEOUT)
    try:
        add(_check_sharded("mesh (1, 1), one rank, NCCL",
                           [_sharded_rank(1, 1, names)], 1, want, subgroups,
                           smi))
    finally:
        dist.destroy_process_group()
    _phase(29, "sharded runtime, one rank (NCCL, mesh (1, 1))", t0)

    t0 = time.time()
    for mesh, names in (((2, 1), ("sweep64", "dryrun_mixed")),
                        ((1, 2), ("pll_sweep8", "qpsk2400_sweep8",
                                  "pll_pair_f64"))):
        want, subgroups = baseline(names)
        t1 = time.time()
        outs = sharded.spawn(_sharded_rank, 2, "cuda", *mesh, names)
        add(_check_sharded(f"mesh {mesh}, two ranks on one card (gloo)",
                           outs, mesh[1], want, subgroups, smi))
        print(f"mesh {mesh}: spawn and both calls of each bank "
              f"{time.time() - t1:.3f} s")
    t1 = time.time()
    dry = sharded.dryrun_multichip(2, "cuda")
    chains, audio, kw = _sharded_case("dryrun_mixed")
    rows = sharded.packet_rows(tbank.run_banked(chains, audio, device=dev,
                                                **kw))
    if dry["first"] != rows:
        raise AssertionError("the dry run's packets differ from run_banked's")
    print(f"dry run at 2 ranks: packets equal to run_banked's "
          f"({time.time() - t1:.3f} s) [{smi}]")
    _phase(30, "sharded runtime, two ranks sharing the card (gloo)", t0)
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pymodem_tpu_torch import _ext, profiling
    from pymodem_tpu_torch.codecs.ax25_device import (
        ax25_deframe,
        ax25_deframe_rows,
    )
    from pymodem_tpu_torch.config import ReportSpec, RunPlan
    from pymodem_tpu_torch.device import resolve
    from pymodem_tpu_torch.dsp.agc import agc_follower, agc_lanes
    from pymodem_tpu_torch.dsp.loops import (
        afsk_pll,
        afsk_pll_lanes,
        bpsk_costas,
        bpsk_costas_lanes,
        mpsk_loop,
        mpsk_loop_lanes,
        mpsk_tables_staged,
        qpsk_costas,
        qpsk_costas_lanes,
    )
    from pymodem_tpu_torch.ops.slicers import (
        binary_slice,
        binary_slice_lanes,
        four_level_slice,
        four_level_slice_lanes,
        quadrature_slice,
        quadrature_slice_lanes,
    )
    from pymodem_tpu_torch.runtime import bank as tbank
    from pymodem_tpu_torch.synth.fixtures import ax25_edge_rows

    # 1. environment
    t0 = time.time()
    dev = resolve("cuda")
    smi = _smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi)
    _phase(1, "environment", t0)

    # 2. build the kernels from csrc/
    t0 = time.time()
    lib = _ext.build(verbose=True)
    _phase(2, f"built {os.path.relpath(lib, ROOT)}", t0)

    banks = _banks()
    expected, audio = _audio()
    audio_t = torch.from_numpy(audio).to(dev)
    kernels = {}

    def check_staged(what, kernel, twin, x, windows):
        """``kernel`` against ``twin`` at the full lane count of ``x`` on
        two slices that are not a multiple of the 128-sample tile: one
        whose rows the staged kernel copies as they are and one it copies
        padded (each route checked), at each of ``windows``.  Returns the
        max abs error and the padded slice."""
        err = 0.0
        for n, aligned in ((ALIGNED_CUT, True), (PADDED_CUT, False)):
            xs = x[:, :n].contiguous()
            _same_route(f"{what} on {n} samples", xs, aligned=aligned)
            for w in windows:
                err = max(err, _same(f"{what} window {w} on {n} samples",
                                     kernel(xs, w), twin(xs, w)))
        return err, xs

    def k1_at(name, x, lp, window):
        """K1 on bank ``name``'s (L, T) basebands ``x``: against its twin
        (``check_staged``), timed at full shape; its kernels-line entry."""
        err, xs = check_staged(f"K1 on {name}",
                               lambda t, w: binary_slice_lanes(t, lp, w),
                               lambda t, w: binary_slice(t, lp, w), x,
                               (1, window))
        plain = _time_ms(lambda: binary_slice(xs, lp, window), 1)
        ms = _time_ms(lambda: binary_slice_lanes(x, lp, window), 5)
        copy_ms = _copy_ms(x)
        aligned = _ext.rows_aligned(x)
        L, T = x.shape
        k = _kernel(
            "binary_slicer", "binary_slicer.cu",
            "pymodem_tpu/ops/pallas_slicers.py:32", err, ms, plain,
            4 * (L * T + 2 * L + L * -(-T // window)), 15 * L * T, (L, T),
            (L, PADDED_CUT), smi)
        before = K1_BEFORE_MS.get(name)
        print(f"K1 on {name} lanes {L} T {T} window {window}: bitwise equal "
              f"on {L}x{ALIGNED_CUT} (rows as they are) and {L}x{PADDED_CUT}"
              f" (padded rows), windows 1 and {window}; twin {plain:.1f} ms "
              f"at {L}x{PADDED_CUT}; kernel {ms:.3f} ms at full {L}x{T}, "
              f"{ms * 1e6 / T:.1f} ns a step, {LANE_TILES}, rows "
              f"{'as they lie' if aligned else 'padded'} (padded-row copy "
              f"{copy_ms:.3f} ms, in the kernel's time); bound "
              f"{k['bound_ms']:.3f} ms; before the redesign: "
              f"{f'{before} ms' if before else 'not measured'} [{smi}]")
        return k

    # 3. the sweep bank's basebands against the CPU, K1 against its twin
    t0 = time.time()
    bank = tbank.group_chains(banks["sweep64"], dev)[0]
    plan = tbank.bank_plan(bank, len(audio),
                           max_packet_seconds=MAX_PACKET_SECONDS)
    frames = tbank.frame_blocks(audio_t, plan).to(torch.float32)
    base_bb = tbank.bank_basebands(bank, frames)
    C, B, L2 = base_bb.shape
    x_full = base_bb.reshape(C * B, L2).contiguous()
    lp = tbank.slicer_lane_params(bank, B)
    window = tbank.slicer_window(bank)
    cpu_bank = tbank.group_chains(banks["sweep64"], "cpu")[0]
    _check_basebands(bank, cpu_bank, frames, base_bb)
    del base_bb
    kernels["K1"] = k1_at("sweep64", x_full, lp, window)
    del x_full, frames
    _phase(3, "K1 binary slicer == twin", t0)

    def coherent_at(key, name, bank_name, x, rows, row_of_lane, tables,
                    kernel, twin, before, ops):
        """K2 or K3 (``kernel``) on bank ``bank_name``'s input rows ``x``
        and its own ``row_of_lane``: against ``twin`` at the full lane count
        on the two cuts (each route checked), timed at full shape; its
        kernels-line entry, whose bound reads the R input rows once."""
        err = 0.0
        for n, aligned in ((ALIGNED_CUT, True), (PADDED_CUT, False)):
            xs = x[:, :n].contiguous()
            _same_route(f"{key} on {n} samples", xs, aligned=aligned)
            err = max(err, _same(f"{key} on {bank_name}, {n} samples",
                                 kernel(xs, rows, *tables, row_of_lane),
                                 twin(xs, rows, *tables, row_of_lane)))
        plain = _time_ms(lambda: twin(xs, rows, *tables, row_of_lane), 1)
        ms = _time_ms(lambda: kernel(x, rows, *tables, row_of_lane), 3)
        L = rows.shape[1]
        R, T = x.shape
        aligned = _ext.rows_aligned(x)
        copy_ms = _copy_ms(x)
        k = _kernel(
            name, "coherent_loop.cu", "pymodem_tpu/dsp/pallas_loops.py:83",
            err, ms, plain,
            4 * (R * T + L * T + 15 * L + 256 * len(tables) + L),
            ops * L * T, (L, T), (L, PADDED_CUT), smi)
        print(f"{key} lanes {L} on {R} shared rows of {bank_name}, T {T}: "
              f"bitwise equal on {L}x{ALIGNED_CUT} (rows as they are) and "
              f"{L}x{PADDED_CUT} (padded rows); twin {plain:.1f} ms at "
              f"{L}x{PADDED_CUT}; kernel {ms:.3f} ms at full {L}x{T}, "
              f"{ms * 1e6 / T:.1f} ns a step, {LANE_TILES}, the AGC's "
              f"divide on one gain warp, rows "
              f"{'as they are' if aligned else 'padded'} (padded-row copy "
              f"{copy_ms:.3f} ms, in the kernel's time); bound "
              f"{k['bound_ms']:.3f} ms; before the redesign: {before} ms "
              f"[{smi}]")
        return k

    # 4. K2 (redesigned: staged tiles, the AGC off the loop's chain; its
    # earlier time beside it) against its twin on the PLL sweep bank's
    # shared rows
    t0 = time.time()
    bank = tbank.group_chains(banks["pll_sweep8"], dev)[0]
    plan = tbank.bank_plan(bank, len(audio),
                           max_packet_seconds=MAX_PACKET_SECONDS)
    frames = tbank.frame_blocks(audio_t, plan).to(torch.float32)
    x_full, rows, row_of_lane = tbank.coherent_loop_inputs(bank.params,
                                                           frames)
    kernels["K2"] = coherent_at(
        "K2", "afsk_pll_loop", "pll_sweep8", x_full, rows, row_of_lane,
        (bank.params["sine_table"],), afsk_pll_lanes, afsk_pll,
        K2_BEFORE_MS, 40)
    del x_full, frames
    _phase(4, "K2 AFSK PLL loop == twin", t0)

    # 5. the AFSK path end to end
    t0 = time.time()
    reports = (ReportSpec("decoded", style="decoded_headers"),)

    def run(plan_, audio_, rate, mps):
        result = tbank.run_plan_banked(plan_, audio_, rate,
                                       max_packet_seconds=mps,
                                       resilient=False, device=dev)
        torch.cuda.synchronize()
        return result

    def run_path(bank_chains, audios, rate_of, mps_of, kernels_of,
                 every_chain=False):
        """Decode each bank once (the main path's run: the caller sets the
        launch counters to 0 before and reads them after); check every
        frame, and with ``every_chain`` that each chain decoded every frame
        itself; fail unless the bank launched each wrapper of
        ``kernels_of[name]``; print each bank's peak device memory against
        the bytes per chain-sample that runtime/bank.py budgets for its
        family, its launches and its padded-row copies (_ext.lane_rows)."""
        for name, chains in bank_chains.items():
            rate = rate_of[name]
            before = {k: fn.launches for k, fn in kernels_of[name].items()}
            copies = _ext.lane_rows.copies
            torch.cuda.reset_peak_memory_stats()
            result = run(RunPlan(chains=tuple(chains), reports=reports),
                         audios[name][1], rate, mps_of[name])
            peak = torch.cuda.max_memory_allocated()
            copies = _ext.lane_rows.copies - copies
            _check_bank(name, result, audios[name][0])
            missed = [k for k, fn in kernels_of[name].items()
                      if fn.launches == before[k]]
            if missed:
                raise AssertionError(f"bank {name} launched no {missed}")
            if every_chain:
                per_chain = [sum(p.valid_crc and p.valid_header for p in ch)
                             for ch in result.aggregate.chains]
                if per_chain != [len(audios[name][0])] * len(chains):
                    raise AssertionError(
                        f"bank {name}: frames decoded per chain {per_chain}"
                        f", expected {len(audios[name][0])} each")
            bank_ = tbank.group_chains(chains, "cpu")[0]
            plan_ = tbank.bank_plan(bank_, len(audios[name][1]),
                                    max_packet_seconds=mps_of[name])
            samples = len(chains) * plan_.n_blocks * plan_.block_input_len
            launched = {k: fn.launches - before[k]
                        for k, fn in kernels_of[name].items()}
            print(f"bank {name}: {len(audios[name][0])} frames decoded, 0 "
                  f"rejected; launches {launched}, padded-row copies "
                  f"{copies}; peak device memory {peak / 2**30:.2f} GiB, "
                  f"{peak / samples:.1f} bytes per chain-sample (budgeted "
                  f"{tbank._BYTES_PER_CHAIN_SAMPLE[bank_.kind]}); host-codec "
                  f"route: {PEAK_HOST_ROUTE_GIB.get(name, 'not measured')} "
                  f"GiB [{smi}]")

    def report_banks(bank_chains, audios, rate_of, mps_of, seconds_of,
                     profile_codec=()):
        """WARM_RUNS warm reruns of each bank (walls, the median's rate,
        chains decoding, the profiled stages over 20 ms of the slowest run;
        no block may go to the host fallback), then a split of one run
        into device stages,
        device codec with its readback (and its stages), host packet
        build, the aggregate (validate, correlate, reports) and, for
        comparison, the host codec on the same arrays, whose packets must
        equal the device codec's.  Banks in ``profile_codec`` also get a
        torch.profiler trace of their device codec."""
        for name, chains in bank_chains.items():
            plan_ = RunPlan(chains=tuple(chains), reports=reports)
            walls, slowest = [], ""
            for _ in range(WARM_RUNS):
                profiling.reset()
                profiling.enable(True)
                t1 = time.time()
                result = run(plan_, audios[name][1], rate_of[name],
                             mps_of[name])
                walls.append(time.time() - t1)
                profiling.enable(False)
                counts = profiling.counts()
                _check_bank(name, result, audios[name][0])
                if counts.get("packet_fallback_blocks", 0):
                    raise AssertionError(
                        f"bank {name}: the warm run sent "
                        f"{counts['packet_fallback_blocks']} blocks to the "
                        f"host fallback ({counts})")
                if walls[-1] == max(walls):
                    slowest = ", ".join(
                        f"{k} {v:.3f}" for k, v in profiling.stages().items()
                        if v > 0.02)
            wall = sorted(walls)[len(walls) // 2]
            msps = len(chains) * len(audios[name][1]) / wall / 1e6
            # chains that decoded packets: the packet build scales with them
            decoding = len(result.aggregate.decoder_histogram)
            print(f"bank {name}: {len(chains)} chains x "
                  f"{seconds_of[name]:.1f} s, {decoding} of them decoding "
                  f"packets, warm walls "
                  f"{', '.join(f'{w:.3f}' for w in walls)} s (median "
                  f"{wall:.3f}; the slowest's profiled stages over 20 ms: "
                  f"{slowest or 'none'}), {msps:.1f} chain-Msamples/s at "
                  f"the median, device codec route, escalations "
                  f"{counts.get('device_codec_escalate', 0)}, fallback blocks "
                  f"0 [{smi}]")
        for name, chains in bank_chains.items():
            bank_ = tbank.group_chains(chains, dev)[0]
            wave = torch.from_numpy(audios[name][1]).to(dev)
            plan_ = tbank.bank_plan(bank_, len(wave),
                                    max_packet_seconds=mps_of[name])
            tol = tbank.sync_tolerance(bank_)
            groups = tbank._codec_subgroups(bank_)
            t1 = time.time()
            arrays = tbank.dispatch_bank(bank_, plan_, wave, tol)
            torch.cuda.synchronize()
            t2 = time.time()
            profiling.reset()
            profiling.enable(True)
            dev_pkts = tbank._device_codec_submit_mixed(
                bank_, plan_, groups, *arrays, 8, None)()
            t3 = time.time()
            profiling.enable(False)
            stages, counts = profiling.stages(), profiling.counts()
            tbank._finish_plan(RunPlan(chains=tuple(chains),
                                       reports=reports), dev_pkts,
                               rate_of[name])
            t4 = time.time()
            host_pkts = tbank.host_codec_collect(bank_, plan_, tol, arrays)
            t5 = time.time()
            build = stages.get("packet_objects", 0.0)
            codec_stages = ", ".join(
                f"{k.replace('device_codec_', '')} {v:.3f}"
                for k, v in stages.items()
                if k.startswith(("device_codec", "codec_", "candidate")))
            print(f"bank {name} split: {plan_.n_blocks} blocks x "
                  f"{plan_.block_input_len} samples, device stages "
                  f"{t2 - t1:.3f} s, device codec with readback "
                  f"{t3 - t2 - build:.3f} s ({codec_stages}), host packet "
                  f"build {build:.3f} s, aggregate {t4 - t3:.3f} s, host "
                  f"codec (for comparison) {t5 - t4:.3f} s; escalations "
                  f"{counts.get('device_codec_escalate', 0)}, fallback "
                  f"blocks {counts.get('packet_fallback_blocks', 0)} [{smi}]")
            _same_packets(name, dev_pkts, host_pkts)
            if counts.get("packet_fallback_blocks", 0):
                raise AssertionError(f"bank {name}: a warm run sent blocks "
                                     f"to the host fallback ({counts})")
            if name in profile_codec:
                _profile_codec(name, bank_, plan_, groups, arrays)
            del arrays

    afsk_audio = {name: (expected, audio) for name in banks}
    afsk_mps = {name: MAX_PACKET_SECONDS for name in banks}
    afsk_rate = {name: RATE for name in banks}
    k1 = {"K1": binary_slice_lanes}
    k12 = {"K1": binary_slice_lanes, "K2": afsk_pll_lanes}
    binary_slice_lanes.launches = 0
    afsk_pll_lanes.launches = 0
    run_path(banks, afsk_audio, afsk_rate, afsk_mps,
             {"sweep64": k1, "pll_pair": k12, "pll_sweep8": k12})
    afsk_launches = {"K1": binary_slice_lanes.launches,
                     "K2": afsk_pll_lanes.launches}
    print(f"AFSK path: launches {afsk_launches}")
    report_banks(banks, afsk_audio, afsk_rate, afsk_mps,
                 {name: SECONDS for name in banks})
    del audio_t
    _phase(5, "AFSK path end to end", t0)

    # 6. the CLI on a WAV and a JSONL config
    t0 = time.time()
    line = _cli((_chain_line("AFSK 300 Il2Pc Correlator", "afsk"),
                 _chain_line("AFSK 300 Il2Pc PLL", "afsk_pll")),
                "afsk300.wav", RATE, audio[: 60 * RATE], 6)
    print(f"CLI: {line}, exit 0")
    _phase(6, "CLI subprocess (AFSK)", t0)

    # 7. K3, K4, K6 and K7 against their twins on the PSK banks' inputs
    t0 = time.time()
    psk = _psk_banks()
    psk_audio = {name: _family_audio(chains[0], PSK_RATE)
                 for name, chains in psk.items()}
    psk_mps = {name: a[3] for name, a in psk_audio.items()}
    psk_rate = {name: PSK_RATE for name in psk}

    def psk_frames(name):
        bank_ = tbank.group_chains(psk[name], dev)[0]
        wave = torch.from_numpy(psk_audio[name][1]).to(dev)
        plan_ = tbank.bank_plan(bank_, len(wave),
                                max_packet_seconds=psk_mps[name])
        return bank_, tbank.frame_blocks(wave, plan_).to(torch.float32)

    # K3 (redesigned as K2 in 4; its earlier time beside it) on the BPSK
    # sweep's shared rows
    bank, frames = psk_frames("bpsk1200_sweep8")
    x, rows, row_of_lane = tbank.coherent_loop_inputs(bank.params, frames)
    kernels["K3"] = coherent_at(
        "K3", "bpsk_costas_loop", "bpsk1200_sweep8", x, rows, row_of_lane,
        (bank.params["sine_table"], bank.params["cos_table"]),
        bpsk_costas_lanes, bpsk_costas, K3_BEFORE_MS, 45)
    del x
    bb = tbank.bank_basebands(bank, frames)
    C, B, L2 = bb.shape
    k1_banks = {"bpsk1200_sweep8": k1_at(
        "bpsk1200_sweep8", bb.reshape(C * B, L2).contiguous(),
        tbank.slicer_lane_params(bank, B), tbank.slicer_window(bank))}
    del bb, frames

    # K4 (redesigned: staged tiles; its earlier times beside it) on both of
    # its banks against the twin at full lane count on the two cuts, timed
    # at full shape
    k4 = {}
    for name in ("qpsk2400_sweep8", "mpsk_bpsk1200_pair"):
        bank, frames = psk_frames(name)
        x, rows = tbank.mpsk_agc_inputs(bank.params, frames)
        err = 0.0
        for n, aligned in ((ALIGNED_CUT, True), (PADDED_CUT, False)):
            xs = x[:, :n].contiguous()
            _same_route(f"K4 on {name}, {n} samples", xs, aligned=aligned)
            err = max(err, _same(f"K4 on {name}, {n} samples",
                                 agc_lanes(xs, rows), agc_follower(xs, rows)))
        plain = _time_ms(lambda: agc_follower(xs, rows), 1)
        ms = _time_ms(lambda: agc_lanes(x, rows), 3)
        L, T = x.shape
        aligned = _ext.rows_aligned(x)
        copy_ms = _copy_ms(x)
        k4[name] = _kernel(
            "agc_lanes", "agc_lanes.cu",
            "pymodem_tpu/dsp/pallas_loops.py:83", err, ms, plain,
            4 * (2 * L * T + 5 * L), 12 * L * T, (L, T), (L, PADDED_CUT),
            smi)
        print(f"K4 on {name} ({len(bank.specs)} chains, "
              f"{'B shared' if 'pre_shared' in bank.params else 'C*B'} "
              f"lanes) lanes {L} T {T}: bitwise equal on {L}x{ALIGNED_CUT} "
              f"(rows as they are) and {L}x{PADDED_CUT} (padded rows); twin "
              f"{plain:.1f} ms at {L}x{PADDED_CUT}; kernel {ms:.3f} ms at "
              f"full {L}x{T}, {ms * 1e6 / T:.1f} ns a step, {LANE_TILES}, "
              f"outputs by four gain warps, "
              f"rows {'as they are' if aligned else 'padded'} (padded-row "
              f"copy {copy_ms:.3f} ms, in the kernel's time); bound "
              f"{k4[name]['bound_ms']:.3f} ms; before the redesign: "
              f"{K4_BEFORE_MS[name]} ms [{smi}]")
        if name == "mpsk_bpsk1200_pair":
            # 1 bit per decision: K7 on the pair's own basebands
            i_d, q_d = tbank.bank_basebands(bank, frames)
            C, B, L3 = i_d.shape
            lanes = [t.reshape(C * B, L3)[:, :SLICE].contiguous()
                     for t in (i_d, q_d)]
            sl = bank.specs[0].slicer
            lp = tbank.slicer_lane_params(bank, B)
            w_pair = tbank.slicer_window(bank)
            for w in (1, w_pair):
                _same(f"K7 (1 bit) window {w}",
                      quadrature_slice_lanes(*lanes, lp, sl.demap,
                                             sl.state_mask, 1, w),
                      quadrature_slice(*lanes, lp, sl.demap, sl.state_mask,
                                       1, w))
            print(f"K7 (1 bit per decision) on {name}: bitwise equal on "
                  f"{C * B}x{SLICE}, windows 1 and {w_pair}")
            del i_d, q_d, lanes
        del x, xs, frames
    kernels["K4"] = max(k4.values(), key=lambda k: k["shape"][0])

    # K6 and K7 (redesigned: staged tiles; their earlier times beside them)
    # against the twin at full lane count on two cuts that are not a
    # multiple of the tile: one whose rows the kernels copy as they are, as
    # on the main path, and one they copy through padded rows; timed at
    # full shape
    bank, frames = psk_frames("qpsk2400_sweep8")
    re, im, rows, pd_tables, pd_index, row_of_lane = \
        tbank.mpsk_loop_inputs(bank.params, frames)
    k6_args = (rows, bank.params["sine_table"], bank.params["cos_table"],
               pd_tables, pd_index, row_of_lane)
    _same_route("K6 at full shape", re, im, aligned=True)
    err = 0.0
    for n, aligned in ((ALIGNED_CUT, True), (PADDED_CUT, False)):
        res, ims = (t[:, :n].contiguous() for t in (re, im))
        _same_route(f"K6 on {n} samples", res, ims, aligned=aligned)
        err = max(err, _same(f"K6 on {n} samples",
                             mpsk_loop_lanes(res, ims, *k6_args),
                             mpsk_loop(res, ims, *k6_args)))
    plain = _time_ms(lambda: mpsk_loop(res, ims, *k6_args), 1)
    ms = _time_ms(lambda: mpsk_loop_lanes(re, im, *k6_args), 3)
    L = rows.shape[1]
    R, T = re.shape
    kernels["K6"] = _kernel(
        "mpsk_loop", "mpsk_loop.cu", "pymodem_tpu/dsp/pallas_loops.py:270",
        err, ms, plain,
        4 * (2 * R * T + 2 * L * T + 12 * L + 512 + pd_tables.numel()
             + 2 * L), 50 * L * T, (L, T), (L, PADDED_CUT), smi)
    staged = mpsk_tables_staged(pd_tables.numel())
    print(f"K6 lanes {L} on {R} shared rows, T {T}, {pd_tables.shape[0]} "
          f"detector table(s): bitwise equal on {L}x{ALIGNED_CUT} (rows as "
          f"they are) and {L}x{PADDED_CUT} (padded rows); twin "
          f"{plain:.1f} ms at {L}x{PADDED_CUT}; kernel {ms:.3f} ms at full "
          f"{L}x{T}, {ms * 1e6 / T:.1f} ns a step, {LANE_TILES}, detector "
          f"tables in {'shared memory' if staged else 'the read-only cache'};"
          f" bound {kernels['K6']['bound_ms']:.3f} ms; before the redesign: "
          f"{K6_BEFORE_MS} ms [{smi}]")
    del re, im, res, ims
    i_d, q_d = tbank.bank_basebands(bank, frames)
    C, B, L3 = i_d.shape
    i_l, q_l = (t.reshape(C * B, L3).contiguous() for t in (i_d, q_d))
    del i_d, q_d
    sl = bank.specs[0].slicer
    lp = tbank.slicer_lane_params(bank, B)
    window = tbank.slicer_window(bank)
    _same_route("K7 at full shape", i_l, q_l, aligned=True)
    err = 0.0
    for n, aligned in ((ALIGNED_CUT, True), (PADDED_CUT, False)):
        i_s, q_s = (t[:, :n].contiguous() for t in (i_l, q_l))
        _same_route(f"K7 on {n} samples", i_s, q_s, aligned=aligned)
        for w in (1, window):
            err = max(err, _same(
                f"K7 window {w} on {n} samples",
                quadrature_slice_lanes(i_s, q_s, lp, sl.demap,
                                       sl.state_mask, 2, w),
                quadrature_slice(i_s, q_s, lp, sl.demap, sl.state_mask, 2,
                                 w)))
    plain = _time_ms(lambda: quadrature_slice(i_s, q_s, lp, sl.demap,
                                              sl.state_mask, 2, window), 1)
    ms = _time_ms(lambda: quadrature_slice_lanes(i_l, q_l, lp, sl.demap,
                                                 sl.state_mask, 2, window), 3)
    L, T = i_l.shape
    kernels["K7"] = _kernel(
        "quadrature_slicer", "quadrature_slicer.cu",
        "pymodem_tpu/ops/pallas_slicers.py:220", err, ms, plain,
        4 * (2 * L * T + 2 * L + L * -(-T // window)), 20 * L * T, (L, T),
        (L, PADDED_CUT), smi)
    print(f"K7 lanes {L} T {T} window {window}: bitwise equal on "
          f"{L}x{ALIGNED_CUT} and {L}x{PADDED_CUT}, windows 1 and {window}; "
          f"twin {plain:.1f} ms at {L}x{PADDED_CUT}; kernel {ms:.3f} ms at "
          f"full {L}x{T}, {ms * 1e6 / T:.1f} ns a step, {LANE_TILES}; bound "
          f"{kernels['K7']['bound_ms']:.3f} ms; before the redesign: "
          f"{K7_BEFORE_MS} ms [{smi}]")
    del i_l, q_l, i_s, q_s, frames
    _phase(7, "K3, K4, K6, K7, K1 == twins", t0)

    # 8. the PSK path end to end
    t0 = time.time()
    counted = {"K1": binary_slice_lanes, "K3": bpsk_costas_lanes,
               "K4": agc_lanes, "K6": mpsk_loop_lanes,
               "K7": quadrature_slice_lanes}
    mpsk_kernels = {k: counted[k] for k in ("K4", "K6", "K7")}
    for fn in counted.values():
        fn.launches = 0
    _ext.lane_rows.copies = 0
    run_path(psk, psk_audio, psk_rate, psk_mps,
             {"bpsk1200_sweep8": {k: counted[k] for k in ("K1", "K3")},
              "qpsk2400_sweep8": mpsk_kernels,
              "mpsk_bpsk1200_pair": mpsk_kernels})
    psk_launches = {k: fn.launches for k, fn in counted.items()}
    print(f"PSK path: launches {psk_launches}, padded-row copies for K1, "
          f"K4, K6 and K7 {_ext.lane_rows.copies}")
    report_banks(psk, psk_audio, psk_rate, psk_mps,
                 {name: len(a[1]) / PSK_RATE for name, a in psk_audio.items()})
    _phase(8, "PSK path end to end", t0)

    # 9. the CLI on a QPSK-2400 config
    t0 = time.time()
    sent, qaudio, seg_len, _ = psk_audio["qpsk2400_sweep8"]
    n_seg = 60 * PSK_RATE // seg_len  # whole segments in the first 60 s
    line = _cli((PSK_LINES["qpsk"],), "qpsk2400.wav", PSK_RATE,
                qaudio[: n_seg * seg_len], 3 * n_seg)
    print(f"CLI: {line}, exit 0")
    _phase(9, "CLI subprocess (QPSK 2400)", t0)

    # 10. K8 and K5 against their twins on the new banks' inputs
    t0 = time.time()
    fsk = _fsk_banks()
    fsk_chains = {name: chains for name, (chains, _) in fsk.items()}
    fsk_rate = {name: rate for name, (_, rate) in fsk.items()}
    fsk_audio = {name: _family_audio(chains[0], fsk_rate[name])
                 for name, chains in fsk_chains.items()}
    fsk_mps = {name: a[3] for name, a in fsk_audio.items()}

    def fsk_frames(name):
        bank_ = tbank.group_chains(fsk_chains[name], dev)[0]
        wave = torch.from_numpy(fsk_audio[name][1]).to(dev)
        plan_ = tbank.bank_plan(bank_, len(wave),
                                max_packet_seconds=fsk_mps[name])
        return bank_, tbank.frame_blocks(wave, plan_).to(torch.float32)

    # the FSK basebands' rows as the bank hands them to K1 and K8: the
    # FIR's output rows, a multiple of 4 floats apart (runtime/bank.py
    # slice_lanes)
    bank, frames = fsk_frames("fsk9600_sweep8")
    bb = tbank.bank_basebands(bank, frames)
    C, B, L2 = bb.shape
    del frames
    k1_banks["fsk9600_sweep8"] = k1_at(
        "fsk9600_sweep8", bb.reshape(C * B, L2),
        tbank.slicer_lane_params(bank, B), tbank.slicer_window(bank))
    del bb

    # K8 (redesigned: staged tiles, the ring's values on four value warps;
    # its earlier time beside it) against the twin at full lane count on
    # the two cuts, timed at full shape
    bank, frames = fsk_frames("fsk4_9600_sweep8")
    bb = tbank.bank_basebands(bank, frames)
    C, B, L2 = bb.shape
    x = bb.reshape(C * B, L2)
    del frames
    lp = tbank.slicer_lane_params(bank, B)
    window = tbank.slicer_window(bank)
    demap = bank.specs[0].slicer.demap
    # the twin on the CPU, where the tests hold it against the JAX scan;
    # the twin on the card must agree with it too
    lp_cpu = lp.cpu()
    err, xs = check_staged(
        "K8", lambda t, w: four_level_slice_lanes(t, lp, demap, w),
        lambda t, w: four_level_slice(t.cpu(), lp_cpu, demap, w).to(dev), x,
        (1, window))
    for w in (1, window):
        _same(f"K8's twin on the card window {w}",
              four_level_slice(xs, lp, demap, w),
              four_level_slice(xs.cpu(), lp_cpu, demap, w).to(dev))
    plain = _time_ms(lambda: four_level_slice(xs, lp, demap, window), 1)
    ms = _time_ms(lambda: four_level_slice_lanes(x, lp, demap, window), 3)
    copy_ms = _copy_ms(x)
    aligned = _ext.rows_aligned(x)
    L, T = x.shape
    kernels["K8"] = _kernel(
        "four_level_slicer", "four_level_slicer.cu",
        "pymodem_tpu/ops/pallas_slicers.py:297", err, ms, plain,
        4 * (L * T + 2 * L + L * -(-T // window)), 35 * L * T, (L, T),
        (L, PADDED_CUT), smi)
    print(f"K8 lanes {L} T {T} window {window}: bitwise equal on "
          f"{L}x{ALIGNED_CUT} (rows as they are) and {L}x{PADDED_CUT} "
          f"(padded rows), windows 1 and {window}, and its twin on the card "
          f"equal to the CPU's; twin {plain:.1f} ms at "
          f"{L}x{PADDED_CUT}; kernel {ms:.3f} ms at full {L}x{T}, "
          f"{ms * 1e6 / T:.1f} ns a step, {LANE_TILES}, ring values on four "
          f"value warps, rows {'as they lie' if aligned else 'padded'} "
          f"(padded-row copy {copy_ms:.3f} ms, in the kernel's time); bound "
          f"{kernels['K8']['bound_ms']:.3f} ms; before the redesign: "
          f"{K8_BEFORE_MS} ms [{smi}]")
    del x, xs, bb

    # K5 (redesigned: staged tiles, the AGC on the copy warp; its earlier
    # time beside it) against the twin at full lane count on the two cuts,
    # on the main path's shared rows and on identity rows (the C*B rows
    # copied out), in the 17-row (AGC fused) and the 12-row form; timed at
    # full shape on the shared rows
    bank, frames = fsk_frames("qpsk_costas2400_sweep8")
    x, rows, row_of_lane = tbank.coherent_loop_inputs(bank.params, frames)
    del frames
    tabs = (bank.params["sine_table"], bank.params["cos_table"])
    err = 0.0
    for n, aligned in ((ALIGNED_CUT, True), (PADDED_CUT, False)):
        xs = x[:, :n].contiguous()
        xi = xs[row_of_lane.long()].contiguous()
        _same_route(f"K5 on {n} samples", xs, xi, aligned=aligned)
        for lp in (rows, rows[:12].contiguous()):
            for inp, rol, what in ((xs, row_of_lane, "shared rows"),
                                   (xi, None, "identity rows")):
                err = max(err, _same(
                    f"K5 ({lp.shape[0]} rows, {what}) on {n} samples",
                    qpsk_costas_lanes(inp, lp, *tabs, rol),
                    qpsk_costas(inp, lp, *tabs, rol)))
    del xi
    plain = _time_ms(lambda: qpsk_costas(xs, rows, *tabs, row_of_lane), 1)
    ms = _time_ms(lambda: qpsk_costas_lanes(x, rows, *tabs, row_of_lane), 3)
    L = rows.shape[1]
    R, T = x.shape
    aligned = _ext.rows_aligned(x)
    copy_ms = _copy_ms(x)
    kernels["K5"] = _kernel(
        "qpsk_costas_loop", "qpsk_costas_loop.cu",
        "pymodem_tpu/dsp/pallas_loops.py:270", err, ms, plain,
        4 * (R * T + 2 * L * T + 17 * L + 512 + L), 60 * L * T, (L, T),
        (L, PADDED_CUT), smi)
    print(f"K5 lanes {L} on {R} shared rows, T {T} ({rows.shape[0]} rows, "
          f"AGC fused): bitwise equal on {L}x{ALIGNED_CUT} (rows as they "
          f"are) and {L}x{PADDED_CUT} (padded rows), shared and identity "
          f"rows, 17 and 12 rows; twin {plain:.1f} ms at {L}x{PADDED_CUT}; "
          f"kernel {ms:.3f} ms at full {L}x{T}, {ms * 1e6 / T:.1f} ns a "
          f"step, {LANE_TILES}, rows {'as they are' if aligned else 'padded'}"
          f" (padded-row copy {copy_ms:.3f} ms, in the kernel's time); bound "
          f"{kernels['K5']['bound_ms']:.3f} ms; before the redesign: "
          f"{K5_BEFORE_MS} ms [{smi}]")
    del x, xs, rows
    _phase(10, "K1, K8, K5 == twins", t0)

    # 11. the FSK and Costas-QPSK path end to end
    t0 = time.time()
    counted = {"K1": binary_slice_lanes, "K5": qpsk_costas_lanes,
               "K7": quadrature_slice_lanes, "K8": four_level_slice_lanes}
    for fn in counted.values():
        fn.launches = 0
    _ext.lane_rows.copies = 0
    run_path(fsk_chains, fsk_audio, fsk_rate, fsk_mps,
             {"fsk9600_sweep8": {"K1": binary_slice_lanes},
              "fsk4_9600_sweep8": {"K8": four_level_slice_lanes},
              "qpsk_costas2400_sweep8": {k: counted[k] for k in ("K5", "K7")}},
             every_chain=True)
    fsk_launches = {k: fn.launches for k, fn in counted.items()}
    print(f"FSK and Costas-QPSK path: launches {fsk_launches}, padded-row "
          f"copies for K1, K5, K7 and K8 {_ext.lane_rows.copies}")
    report_banks(fsk_chains, fsk_audio, fsk_rate, fsk_mps,
                 {name: len(a[1]) / fsk_rate[name]
                  for name, a in fsk_audio.items()},
                 profile_codec=("fsk9600_sweep8",))
    _phase(11, "FSK and Costas-QPSK path end to end", t0)

    # 12. the CLI on a 4FSK config
    t0 = time.time()
    sent, faudio, seg_len, _ = fsk_audio["fsk4_9600_sweep8"]
    n_seg = 60 * FSK4_RATE // seg_len  # whole segments in the first 60 s
    line = _cli((FSK_LINES["fsk4"],), "fsk4_9600.wav", FSK4_RATE,
                faudio[: n_seg * seg_len], 3 * n_seg)
    print(f"CLI: {line}, exit 0")
    _phase(12, "CLI subprocess (4FSK 9600)", t0)

    # 13. forced escalation of the device codec on the card
    t0 = time.time()
    chain, sent, dense = _dense_afsk1200()
    geom = dict(block_seconds=2.0, overlap_seconds=1.5, device=dev)
    roomy = tbank.run_banked([chain], dense, max_packets_per_block=16,
                             **geom)
    profiling.reset()
    profiling.enable(True)
    forced = tbank.run_banked([chain], dense, **FORCED_BUDGETS, **geom)
    profiling.enable(False)
    counts = profiling.counts()
    _same_packets("dense AFSK-1200 (forced escalation)", forced, roomy)
    got = [bytes(p.data[16:-2]) for p in forced[chain.name]]
    if counts.get("device_codec_escalate", 0) < 1 or got != sent:
        raise AssertionError(f"forced escalation: {counts}; {len(got)} of "
                             f"{len(sent)} frames")
    print(f"forced escalation on {len(sent)} dense AFSK-1200 frames, "
          f"{FORCED_BUDGETS}: every frame, packets equal to the roomy run's"
          f"; escalations {counts['device_codec_escalate']}, fallback "
          f"blocks {counts.get('packet_fallback_blocks', 0)}")
    _phase(13, "forced escalation == roomy run", t0)

    # 14. K9 against its twin on the AX.25 sweep's own rows and on edge rows
    t0 = time.time()
    ax_banks = _ax25_banks()
    ax_chains = {name: chains for name, (chains, _) in ax_banks.items()}
    ax_rate = {name: rate for name, (_, rate) in ax_banks.items()}
    ax_audio = {
        "ax25_afsk1200_sweep8": _ax25_audio(
            ax_chains["ax25_afsk1200_sweep8"][0]),
        "mixed_afsk300_ax25_il2p": _mixed_audio(),
    }
    ax_mps = {name: a[3] for name, a in ax_audio.items()}
    name = "ax25_afsk1200_sweep8"
    bank = tbank.group_chains(ax_chains[name], dev)[0]
    wave = torch.from_numpy(ax_audio[name][1]).to(dev)
    plan = tbank.bank_plan(bank, len(wave), max_packet_seconds=ax_mps[name])
    data, _, count, _ = tbank.dispatch_bank(bank, plan, wave,
                                            tbank.sync_tolerance(bank))
    rows = data.reshape(-1, data.shape[-1]).to(torch.uint8).contiguous()
    counts = count.reshape(-1).contiguous()
    del data, count, wave
    N, K = rows.shape
    mp = 8  # the bank's first packet-slot budget (run_banked's default)
    err = _same(f"K9 on {name}'s {N} rows",
                ax25_deframe_rows(rows, counts, mp, 18, 1023),
                ax25_deframe(rows, counts, mp, 18, 1023))
    edge_rows, edge_counts = _ax25_edge_rows(dev)
    dropped = 0
    for slots, cap in ((8, 1023), (2, 1023), (8, 200)):
        got = ax25_deframe_rows(edge_rows, edge_counts, slots, 18, cap)
        err = max(err, _same(f"K9 on edge rows, {slots} slots, cap {cap}",
                             got, ax25_deframe(edge_rows, edge_counts, slots,
                                               18, cap)))
        dropped += int((got[6] > slots).sum())
    if not dropped:
        raise AssertionError("K9's edge rows held no more closing flags "
                             "than packet slots")
    # the scan's edge rows (synth/fixtures.ax25_edge_rows) at odd K: runs
    # of ones across words and the threads', warps' and tiles' spans, all
    # ones, closing flags at every bit of a word, back-to-back frames; at
    # full counts, and at 0, short and past K
    scan_rows, scan_names = ax25_edge_rows(AX25_SCAN_K,
                                           np.random.default_rng(SEED))
    scan_rows = torch.from_numpy(scan_rows).to(dev)
    n_scan = scan_rows.shape[0]
    scan_counts = torch.full((n_scan,), AX25_SCAN_K, dtype=torch.int32,
                             device=dev)
    scan_counts[1::4] = 0
    scan_counts[2::4] = AX25_SCAN_K + 9
    scan_counts[3::4] = 3 + 97 * torch.arange(
        len(scan_counts[3::4]), dtype=torch.int32, device=dev)
    scan_closes = 0
    for counts_ in (torch.full_like(scan_counts, AX25_SCAN_K), scan_counts):
        for slots in (8, 2):
            got = ax25_deframe_rows(scan_rows, counts_, slots, 18, 1023)
            err = max(err, _same(f"K9 on the scan's edge rows, {slots} "
                                 "slots", got, ax25_deframe(
                                     scan_rows, counts_, slots, 18, 1023)))
            scan_closes = max(scan_closes, int(got[6].sum()))
    plain = _time_ms(lambda: ax25_deframe(rows, counts, mp, 18, 1023), 1)
    ms = _time_ms(lambda: ax25_deframe_rows(rows, counts, mp, 18, 1023), 20,
                  queued=True)
    n_in = int(counts.clamp(0, K).sum())
    # ~8 integer operations a bit: classes, the bit-sliced counts, bytes
    kernels["K9"] = _kernel(
        "ax25_deframe", "ax25_deframe.cu",
        "pymodem_tpu/codecs/ax25_device.py:128", err, ms, plain,
        n_in + 4 * N + 8 * N * K + 4 * N + 12 * N * mp + 4 * N,
        8 * 8 * n_in, (N, K), (N, K), smi)
    kernels["K9"]["replaces_kind"] = "lax.scan (no Pallas kernel)"
    print(f"K9 rows {N} K {K} ({n_in} bytes in, {8 * n_in / N:.0f} bits a "
          f"row on average): bitwise equal to its twin on the bank's rows "
          f"and on {edge_rows.shape[0]} edge rows (stuffing, aborts, a frame"
          f" over 1023 bytes, {dropped} rows with more closing flags than "
          f"slots; 8 and 2 slots, caps 1023 and 200) and on {n_scan} scan "
          f"edge rows of {AX25_SCAN_K} bytes ({scan_closes} closing flags; "
          f"{', '.join(scan_names[:2])}, ...); twin {plain:.1f} ms at full "
          f"{N}x{K}; kernel {ms:.4f} ms, {K9_DESIGN}; "
          f"{K9_BEFORE_MS:.3f} ms before the redesign; bound "
          f"{kernels['K9']['bound_ms']:.4f} ms [{smi}]")
    del rows, counts, edge_rows, edge_counts, scan_rows, scan_counts
    _phase(14, "K9 AX.25 deframer == twin", t0)

    # 15. the AX.25 path end to end
    t0 = time.time()
    counted = {"K1": binary_slice_lanes, "K9": ax25_deframe_rows}
    for fn in counted.values():
        fn.launches = 0
    for name, chains in ax_chains.items():
        run_path({name: chains}, ax_audio, ax_rate, ax_mps,
                 {name: counted},
                 every_chain=name == "ax25_afsk1200_sweep8")
    ax_launches = {k: fn.launches for k, fn in counted.items()}
    print(f"AX.25 path: launches {ax_launches}")
    report_banks(ax_chains, ax_audio, ax_rate, ax_mps,
                 {name: len(a[1]) / ax_rate[name]
                  for name, a in ax_audio.items()})
    _phase(15, "AX.25 path end to end", t0)

    # 16. the CLI on an AX.25 config
    t0 = time.time()
    sent, xaudio, seg_len, _ = ax_audio["ax25_afsk1200_sweep8"]
    n_seg = 60 * AX25_RATE // seg_len  # whole segments in the first 60 s
    line = _cli((AX25_LINES["afsk1200"],), "afsk1200_ax25.wav", AX25_RATE,
                xaudio[: n_seg * seg_len], 3 * n_seg)
    print(f"CLI: {line}, exit 0")
    _phase(16, "CLI subprocess (AFSK 1200 AX.25)", t0)

    # 17-22. the front doors
    paths = _front_doors(
        dev, smi, banks, (expected, audio), psk_audio, fsk_audio, ax_chains,
        ax_audio, ax_mps,
        {"K1": binary_slice_lanes, "K2": afsk_pll_lanes,
         "K3": bpsk_costas_lanes, "K4": agc_lanes,
         "K5": qpsk_costas_lanes, "K6": mpsk_loop_lanes,
         "K7": quadrature_slice_lanes, "K8": four_level_slice_lanes,
         "K9": ax25_deframe_rows})
    # 23-24. the streaming decoder
    paths += _stream_phases(
        dev, smi, banks, (expected, audio), ax_chains, ax_audio, ax_mps,
        {"K1": binary_slice_lanes, "K2": afsk_pll_lanes,
         "K9": ax25_deframe_rows})
    # 25-27. the float64 parity mode
    every_wrapper = _all_wrappers()
    f64_entries, _ = _f64_phases(
        dev, smi, banks, (expected, audio), psk, psk_audio, fsk_chains,
        fsk_audio, every_wrapper)
    # 28. the float64 mode through the multi-recording front doors and
    # the stream
    f64_doors = _f64_front_doors(dev, smi, banks, (expected, audio),
                                 every_wrapper)
    for key, entry in f64_entries.items():
        entry["launches"] += f64_doors.get(key, 0)
    kernels.update(f64_entries)
    # 29-30. the sharded runtime
    sharded_launches = _sharded_phases(dev, smi)
    for key, entry in f64_entries.items():
        entry["launches"] += sharded_launches.get(key, 0)
    paths.append(sharded_launches)

    for key, fn_count in (("K1", afsk_launches["K1"] + psk_launches["K1"]
                           + fsk_launches["K1"] + ax_launches["K1"]),
                          ("K2", afsk_launches["K2"]),
                          ("K3", psk_launches["K3"]),
                          ("K4", psk_launches["K4"]),
                          ("K5", fsk_launches["K5"]),
                          ("K6", psk_launches["K6"]),
                          ("K7", psk_launches["K7"] + fsk_launches["K7"]),
                          ("K8", fsk_launches["K8"]),
                          ("K9", ax_launches["K9"])):
        kernels[key]["launches"] = fn_count + sum(path.get(key, 0)
                                                  for path in paths)
    kernels["K1"]["other_banks"] = {
        name: {key: k[key] for key in ("shape", "max_abs_err", "ms",
                                       "plain_ms", "bound_ms")}
        for name, k in k1_banks.items()}
    print(smi)
    print(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
