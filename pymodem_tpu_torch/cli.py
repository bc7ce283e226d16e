"""Command-line entry point: ``python -m pymodem_tpu_torch <config.json> <audio.wav>``.

Same arguments, exit codes (2 bad argv, 3 bad config, 4 bad wav) and report
text as ``python -m pymodem_tpu`` (reference pymodem.py:5-9,25-49).  The
device comes from ``PYMODEM_TPU_TORCH_DEVICE`` (default ``cuda``); a CUDA
request without a GPU fails, it does not fall back to the CPU.  Errors in
the decode propagate and the process exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) != 3:
        print("Not enough arguments. Usage: python3 -m pymodem_tpu_torch "
              "<config json> <sound file>")
        return 2
    return run_decode(argv[1], argv[2])


def run_decode(config_path: str, wav_path: str) -> int:
    """Validate inputs, run the plan on the banked runtime, print reports."""
    from .config import load_plan
    from .device import from_env
    from .runtime.bank import run_plan_banked
    from .wav_io import read_wav

    # the reference validates the config BEFORE the audio (pymodem.py:35-46),
    # so exit 3 wins when both are bad; chains need the WAV's sample rate,
    # so the JSONL is syntax-checked here and built after
    try:
        with open(config_path) as fh:
            for raw in fh:
                if raw.strip():
                    json.loads(raw)
    except Exception:  # any unreadable config is exit 3, as the reference
        print("Unable to open config json file.")
        return 3
    try:
        sample_rate, audio = read_wav(wav_path)
    except Exception:  # any unreadable audio is exit 4, as the reference
        print("Unable to open audio file.")
        return 4
    try:
        plan = load_plan(config_path, sample_rate)
    except Exception as exc:  # noqa: BLE001 - exit 3, as the reference
        print(f"Unable to open config json file. ({exc})")
        return 3

    device = from_env()
    print(f"Built {len(plan.chains)} demod chains")
    start = time.time()
    result = run_plan_banked(plan, audio, sample_rate, verbose=True,
                             device=device)
    for report_spec, text in zip(plan.reports, result.reports):
        print(f"Generating {report_spec.name}")
        print(text)
    print(f"Elapsed time: {round(time.time() - start, 2)} seconds.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
