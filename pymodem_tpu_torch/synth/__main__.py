"""Golden-WAV generator CLI.

    python -m pymodem_tpu_torch.synth <config.json | family> <out.wav> \
        [--rate HZ] [--seconds N] [--snr DB] [--seed N]

Port of ``python -m pymodem_tpu.synth``: the same arguments, family and
rate tables and config directory, so one command writes the same WAV bytes
and prints the same lines in both packages.  Given a JSONL config (same
format the decoder takes), synthesizes audio matched to the config's FIRST
chain -- codec framing, scrambler poly/invert, modem tones and rates all
read from the parsed spec -- so ``python -m pymodem_tpu_torch <config>
<out.wav>`` decodes the printed frames.  Family names are shorthands for
bundled reference configs.  Numpy only: it imports no torch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import fixtures as fx
from . import modulate as mod
from ..config import load_plan
from ..wav_io import write_wav

_CONFIG_DIR = "/root/reference/configs"

# family name -> (bundled config, natural sample rate)
FAMILIES = {
    "afsk1200": ("afsk_1200_il2p.json", 44100),
    "afsk300": ("afsk_300.json", 8000),
    "afskpll300": ("afsk_300_pll.json", 8000),
    "fsk9600": ("fsk_9600.json", 96000),
    "bpsk300": ("bpsk_300.json", 8000),
    "bpsk1200": ("bpsk_1200.json", 44100),
    "qpsk2400": ("qpsk_2400.json", 44100),
    "4fsk9600": ("4fsk_9600.json", 48000),
}

# natural rates for bundled configs passed by path (the decoder reads the
# rate from the WAV; the synthesizer must pick one the presets suit)
_DEFAULT_RATES = {
    "afsk_1200": 44100, "afsk_300": 8000, "bpsk_300": 8000,
    "bpsk_1200": 44100, "qpsk_600": 44100, "qpsk_2400": 44100,
    "qpsk_3600": 44100, "fsk_9600": 96000, "fsk_4800": 48000,
    "4fsk_9600": 48000, "4fsk_19200": 96000,
}


def _guess_rate(path: str) -> int:
    base = os.path.basename(path)
    for prefix, rate in sorted(_DEFAULT_RATES.items(), key=lambda kv: -len(kv[0])):
        if base.startswith(prefix):
            return rate
    return 44100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pymodem_tpu_torch.synth")
    ap.add_argument("source", help="JSONL config path or family name "
                    f"({', '.join(sorted(FAMILIES))})")
    ap.add_argument("out")
    ap.add_argument("--rate", type=int, default=None, help="sample rate (Hz)")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--snr", type=float, default=None, help="AWGN SNR in dB")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.source in FAMILIES:
        cfg, rate = FAMILIES[args.source]
        path = os.path.join(_CONFIG_DIR, cfg)
    else:
        path = args.source
        rate = _guess_rate(path)
    rate = args.rate or rate
    if not os.path.exists(path):
        print(f"config not found: {path}")
        return 3

    plan = load_plan(path, rate)
    if not plan.chains:
        print("config has no demod_chain")
        return 3
    chain = plan.chains[0]

    rng = np.random.default_rng(args.seed)
    sl = chain.slicer
    bits_per_sec = sl.symbol_rate * getattr(sl, "bits_per_symbol", 1)
    frame_bits = 1200  # ~ one short IL2P/AX.25 frame incl. framing
    n_frames = max(1, int(args.seconds * bits_per_sec / (frame_bits + 800)))
    sent, audio = fx.synthesize_for_chain(
        chain, rate, rng, n_frames=n_frames, size=40, gap_bits=800
    )

    if args.snr is not None:
        audio = mod.awgn(audio, args.snr, rng)
    write_wav(args.out, rate, mod.to_int16(audio))
    print(f"wrote {args.out}: {len(audio) / rate:.1f}s @ {rate} Hz, "
          f"{n_frames} frames for chain '{chain.name}'")
    for i, p in enumerate(sent):
        print(f"  frame {i}: {p.decode()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
