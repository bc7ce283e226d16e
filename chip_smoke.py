#!/usr/bin/env python3
"""Smoke run of ``pymodem_tpu_torch``, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Drives the port's main path -- the banked AFSK-300 IL2P+CRC decode on the
host-codec route -- through ``run_plan_banked`` and through its CLI, on
600 s of synthesised 8 kHz int16 audio, and holds the hand-written kernels
against their plain PyTorch twins.  Phases, each printing one line with its
seconds:

1. environment: torch and CUDA versions, the card, its power limit;
2. build kernels K1 and K2 from ``pymodem_tpu_torch/csrc`` with nvcc;
3. K1 (binary slicer) against its twin on the 64-chain sweep bank's own
   basebands (all lanes, a time slice), window 1 and the bank's window:
   bitwise;
4. K2 (AFSK PLL + AGC) against its twin on the 8-chain PLL bank's own
   band-passed lanes (a time slice): bitwise;
5. the main path end to end, with the kernels' launch counters reset just
   before and read just after: the 64-chain space-gain sweep, the PLL
   inverted pair and the 8-chain PLL carrier sweep, each decoding every
   synthesised frame, payload for payload, with no rejected packet; then a
   warm rerun of each for wall time and chain-Msamples/s, and a split of
   one run into device stages and host codec;
6. the CLI as a subprocess on a WAV and a JSONL config in a temp dir.

Any failure raises and the script exits non-zero.  Without a CUDA GPU, or
outside a checkout of the repository, it exits non-zero before printing a
result.  The last three lines are the card's ``nvidia-smi`` name and power
limit, one JSON object describing each kernel (launches on the main path,
max abs error against the twin, kernel and twin milliseconds at the
compared shape), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

ROOT = os.path.dirname(os.path.abspath(__file__))
RATE = 8000
SECONDS = 600
MAX_PACKET_SECONDS = 3.0  # the synthesised frames' wire time bound
SLICE = 4096  # time slice of the twin comparisons (samples per lane)
SEED = 20261016


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


def _banks():
    """The main path's three chain banks: bench.py's 64-chain AFSK-300
    space-gain sweep, the afsk_300_pll-style inverted pair, and an 8-chain
    PLL carrier sweep."""
    from pymodem_tpu_torch.config import build_chain_spec

    def chain(*args):
        return build_chain_spec(float(RATE), _chain_line(*args))

    def variant(spec, name, **modem):
        # the codec's ident names the decoder in the reports; cross-chain
        # dedup only merges packets of different decoders
        return replace(spec, name=name, modem=replace(spec.modem, **modem),
                       codec=replace(spec.codec, ident=name))

    base = chain("AFSK 300 Il2Pc Correlator", "afsk")
    pll = chain("AFSK 300 Il2Pc PLL", "afsk_pll", "no")
    return {
        "sweep64": [variant(base, f"s{i}", space_gain=0.7 + 0.005 * i)
                    for i in range(64)],
        "pll_pair": [pll, chain("AFSK 300 Il2Pc PLL inverted", "afsk_pll",
                                "yes")],
        "pll_sweep8": [variant(pll, f"pll{i}", carrier_freq=1696.0 + i)
                       for i in range(8)],
    }


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


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pymodem_tpu_torch import _ext
    from pymodem_tpu_torch.config import ReportSpec, RunPlan
    from pymodem_tpu_torch.device import resolve
    from pymodem_tpu_torch.dsp.loops import afsk_pll, afsk_pll_lanes
    from pymodem_tpu_torch.ops.slicers import binary_slice, binary_slice_lanes
    from pymodem_tpu_torch.runtime import bank as tbank

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
    kernels = []

    # 3. K1 against its twin on the sweep bank's basebands
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
    # the device demod against the same code on the CPU, on two blocks:
    # f32 sums in another order, so a few ulps of the terms, same signs
    cpu_bank = tbank.group_chains(banks["sweep64"], "cpu")[0]
    ref = tbank.bank_basebands(cpu_bank, frames[:2].cpu())
    dev_bb = base_bb[:, :2].cpu()
    rel = float((dev_bb - ref).abs().max() / ref.abs().max())
    sign = float((torch.sign(dev_bb) == torch.sign(ref)).double().mean())
    print(f"sweep basebands, device vs CPU on 2 blocks: max |diff| / max "
          f"|ref| = {rel:.3g}, sign agreement {sign:.6f}")
    if not (rel < 1e-5 and sign > 0.999):
        raise AssertionError("device basebands disagree with the CPU")
    del base_bb, dev_bb, ref
    x_slice = x_full[:, :SLICE].contiguous()
    err = 0
    for w in (1, window):
        got = binary_slice_lanes(x_slice, lp, w)
        want = binary_slice(x_slice, lp, w)
        torch.cuda.synchronize()
        err = max(err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its twin at window {w}")
    k1_ms = _time_ms(lambda: binary_slice_lanes(x_slice, lp, window), 20)
    k1_plain = _time_ms(lambda: binary_slice(x_slice, lp, window), 1)
    k1_full = _time_ms(lambda: binary_slice_lanes(x_full, lp, window), 5)
    kernels.append(dict(
        name="binary_slicer", route="cuda",
        source="pymodem_tpu_torch/csrc/binary_slicer.cu",
        replaces="pymodem_tpu/ops/pallas_slicers.py:32",
        max_abs_err=err, ms=k1_ms, plain_ms=k1_plain))
    print(f"K1 lanes {C * B} T {L2} window {window}: bitwise equal on "
          f"{C * B}x{SLICE}; kernel {k1_ms:.3f} ms vs twin {k1_plain:.1f} "
          f"ms at {C * B}x{SLICE}; kernel {k1_full:.3f} ms at full "
          f"{C * B}x{L2} [{smi}]")
    del x_full, x_slice, frames
    _phase(3, "K1 binary slicer == twin", t0)

    # 4. K2 against its twin on the PLL sweep bank's lanes
    t0 = time.time()
    bank = tbank.group_chains(banks["pll_sweep8"], dev)[0]
    plan = tbank.bank_plan(bank, len(audio),
                           max_packet_seconds=MAX_PACKET_SECONDS)
    frames = tbank.frame_blocks(audio_t, plan).to(torch.float32)
    x_full, rows = tbank.afsk_pll_loop_inputs(bank.params, frames)
    table = bank.params["sine_table"]
    x_slice = x_full[:, :SLICE].contiguous()
    got = afsk_pll_lanes(x_slice, rows, table)
    want = afsk_pll(x_slice, rows, table)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("K2 output is not finite")
    k2_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"K2 differs from its twin (max {k2_err})")
    k2_ms = _time_ms(lambda: afsk_pll_lanes(x_slice, rows, table), 20)
    k2_plain = _time_ms(lambda: afsk_pll(x_slice, rows, table), 1)
    k2_full = _time_ms(lambda: afsk_pll_lanes(x_full, rows, table), 5)
    kernels.append(dict(
        name="afsk_pll_loop", route="cuda",
        source="pymodem_tpu_torch/csrc/afsk_pll_loop.cu",
        replaces="pymodem_tpu/dsp/pallas_loops.py:83",
        max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain))
    print(f"K2 lanes {x_full.shape[0]} T {x_full.shape[1]}: bitwise equal on "
          f"{x_full.shape[0]}x{SLICE}; kernel {k2_ms:.3f} ms vs twin "
          f"{k2_plain:.1f} ms at {x_full.shape[0]}x{SLICE}; kernel "
          f"{k2_full:.3f} ms at full {x_full.shape[0]}x{x_full.shape[1]} "
          f"[{smi}]")
    del x_full, x_slice, frames
    _phase(4, "K2 AFSK PLL loop == twin", t0)

    # 5. the main path end to end
    t0 = time.time()
    reports = (ReportSpec("decoded", style="decoded_headers"),)
    plans = {name: RunPlan(chains=tuple(chains), reports=reports)
             for name, chains in banks.items()}

    def run(name):
        result = tbank.run_plan_banked(
            plans[name], audio, RATE, max_packet_seconds=MAX_PACKET_SECONDS,
            device=dev)
        torch.cuda.synchronize()
        return result

    binary_slice_lanes.launches = 0
    afsk_pll_lanes.launches = 0
    results = {name: run(name) for name in plans}
    launches = {"binary_slicer": binary_slice_lanes.launches,
                "afsk_pll_loop": afsk_pll_lanes.launches}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if launches["binary_slicer"] < 3 or launches["afsk_pll_loop"] < 2:
        raise AssertionError(f"main path missed a kernel: {launches}")
    for name, result in results.items():
        _check_bank(name, result, expected)
    print(f"main path: {len(expected)} frames decoded in each bank, 0 "
          f"rejected; launches {launches}")
    for name, chains in banks.items():
        t1 = time.time()
        result = run(name)
        wall = time.time() - t1
        _check_bank(name, result, expected)
        msps = len(chains) * len(audio) / wall / 1e6
        # chains that decoded packets: the host codec's work scales with them
        decoding = len(result.aggregate.decoder_histogram)
        print(f"bank {name}: {len(chains)} chains x {SECONDS} s, "
              f"{decoding} of them decoding packets, warm wall {wall:.3f} s, "
              f"{msps:.1f} chain-Msamples/s [{smi}]")
    # where one warm run's time goes: device stages vs the host codec
    for name, chains in banks.items():
        bank = tbank.group_chains(chains, dev)[0]
        plan = tbank.bank_plan(bank, len(audio),
                               max_packet_seconds=MAX_PACKET_SECONDS)
        tol = tbank.sync_tolerance(bank)
        t1 = time.time()
        arrays = tbank.dispatch_bank(bank, plan, audio_t, tol)
        torch.cuda.synchronize()
        t2 = time.time()
        tbank.host_codec_collect(bank, plan, tol, arrays)
        t3 = time.time()
        print(f"bank {name} split: {plan.n_blocks} blocks x "
              f"{plan.block_input_len} samples, device stages "
              f"{t2 - t1:.3f} s, host codec {t3 - t2:.3f} s")
    _phase(5, "main path end to end", t0)

    # 6. the CLI on a WAV and a JSONL config
    t0 = time.time()
    from pymodem_tpu_torch.wav_io import write_wav

    n_frames = 6  # the first 60 s: two segments
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "afsk300.wav")
        cfg = os.path.join(tmp, "afsk300.json")
        write_wav(wav, RATE, audio[: 60 * RATE])
        with open(cfg, "w") as fh:
            for line in (_chain_line("AFSK 300 Il2Pc Correlator", "afsk"),
                         _chain_line("AFSK 300 Il2Pc PLL", "afsk_pll"),
                         {"object_name": "report", "object_type": "report",
                          "options": {"style": "decoded_headers"}}):
                fh.write(json.dumps(line) + "\n")
        env = dict(os.environ, PYTHONPATH=ROOT,
                   PYMODEM_TPU_TORCH_DEVICE="cuda")
        proc = subprocess.run(
            [sys.executable, "-m", "pymodem_tpu_torch", cfg, wav], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    line = f"Unique, valid packets:  {n_frames}"
    if line not in proc.stdout:
        raise AssertionError(f"CLI did not print {line!r}:\n"
                             f"{proc.stdout[-3000:]}")
    print(f"CLI: {line}, exit 0")
    _phase(6, "CLI subprocess", t0)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
