"""Command-line entry point: ``python -m pymodem_tpu_torch <config.json> <audio.wav>``.

Same arguments, exit codes (2 bad argv, 3 bad config, 4 bad wav) and report
text as ``python -m pymodem_tpu`` (reference pymodem.py:5-9,25-49); exit 1
when a decode left the GPU lost (a sticky CUDA error, which the runtime
names once).  The
JAX package's environment variables, read under the
``PYMODEM_TPU_TORCH_`` prefix (so a port CLI never reaches a JAX server):

* ``PYMODEM_TPU_TORCH_DEVICE``: the device (default ``cuda``); a CUDA
  request without a GPU fails, it does not fall back to the CPU;
* ``PYMODEM_TPU_TORCH_X64``: the float64 parity mode (set and not ``0``,
  empty or ``false``, ``mode.x64``): the decode runs float64, on the
  device ``PYMODEM_TPU_TORCH_DEVICE`` names (the H100 has native float64;
  the JAX package moves its f64 runs to the CPU because a TPU has none);
* ``PYMODEM_TPU_TORCH_RUNTIME``: ``auto`` (the default) runs the banked
  runtime (``runtime/bank.py``, with its resilient retry), or under the
  float64 mode the sequential executor (``runtime/executor.py``), as the
  JAX package resolves it; ``banked`` and ``sequential`` name one;
* ``PYMODEM_TPU_TORCH_SERVER``: the socket of a running decode server
  (``python -m pymodem_tpu_torch.serve <socket>``); the request goes
  there, and this process imports no torch;
* ``PYMODEM_TPU_TORCH_PROFILE``: print the stage timings after the
  reports (``profiling.report``); a value other than 1, true or yes is a
  directory for a ``torch.profiler`` trace of the decode.
"""

from __future__ import annotations

import json
import os
import sys
import time

ENV_PREFIX = "PYMODEM_TPU_TORCH_"


def _env(name: str, default: str = "") -> str:
    return os.environ.get(ENV_PREFIX + name, default)


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) != 3:
        print("Not enough arguments. Usage: python3 -m pymodem_tpu_torch "
              "<config json> <sound file>")
        return 2

    # warm-pool routing: a decode server (serve.py) keeps the CUDA context,
    # the kernel library and the codec's budgets warm across invocations;
    # the client path imports no torch
    server = _env("SERVER")
    if server:
        if os.path.exists(server):
            from .serve import client_request

            code, output = client_request(server, argv[1], argv[2])
            sys.stdout.write(output)
            return code
        print(f"decode server socket not found: {server}", file=sys.stderr)

    return run_decode(argv[1], argv[2])


def runtime_name() -> str:
    """The runtime PYMODEM_TPU_TORCH_RUNTIME names: ``auto`` resolves to
    ``banked``, or to ``sequential`` in the float64 parity mode; any other
    name than ``banked`` is the sequential executor, as in the JAX
    package."""
    from .mode import x64

    runtime = _env("RUNTIME", "auto")
    if runtime == "auto":
        return "sequential" if x64() else "banked"
    return runtime


def run_decode_many(config_path: str, wav_paths: list[str]
                    ) -> list[tuple[int, str]]:
    """Pipelined decode of several requests sharing one config."""
    return run_decode_batch([(config_path, w) for w in wav_paths])


def run_decode_batch(requests: list[tuple[str, str]]
                     ) -> list[tuple[int, str]]:
    """Pipelined decode of queued (config, wav) requests, the decode
    server's batch path: on the banked runtime every request's device work
    is queued before earlier requests' readbacks
    (``bank.run_plans_banked_pipelined``), across different configs too.
    Returns (exit code, captured output) per request, the output equal to
    ``run_decode``'s.  The sequential runtime, the float64 mode (whose
    pipelined route is not yet ported), a single request, any diagnostic
    and any exception take one-at-a-time runs instead."""
    import contextlib
    import io

    from .mode import x64

    def _one(config, wav):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = run_decode(config, wav)
        return code, buf.getvalue()

    if runtime_name() != "banked" or x64() or len(requests) == 1:
        return [_one(c, w) for c, w in requests]

    from .config import load_plan
    from .device import from_env
    from .runtime.bank import run_plans_banked_pipelined
    from .wav_io import read_wav

    outputs: list[tuple[int, str] | None] = [None] * len(requests)
    cfg_ok: dict[str, bool] = {}
    plans: dict[tuple[str, float], object] = {}
    jobs: list[tuple[int, object, object, float]] = []
    for i, (config, wav) in enumerate(requests):
        if config not in cfg_ok:
            try:
                with open(config) as fh:
                    for raw in fh:
                        if raw.strip():
                            json.loads(raw)
                cfg_ok[config] = True
            except Exception:  # any unreadable config is exit 3
                cfg_ok[config] = False
        if not cfg_ok[config]:
            outputs[i] = (3, "Unable to open config json file.\n")
            continue
        try:
            rate, audio = read_wav(wav)
        except Exception:  # any unreadable audio is exit 4
            outputs[i] = (4, "Unable to open audio file.\n")
            continue
        key = (config, rate)
        if key not in plans:
            try:
                plans[key] = load_plan(config, rate)
            except Exception as exc:  # noqa: BLE001 - exit 3
                plans[key] = (3, f"Unable to open config json file. ({exc})\n")
        plan = plans[key]
        if isinstance(plan, tuple):
            outputs[i] = plan
            continue
        jobs.append((i, plan, audio, rate))
    if jobs:
        start = time.time()
        diag = io.StringIO()
        try:
            # resilience diagnostics belong to the request that caused
            # them, which a batch-wide capture cannot tell: any diagnostic,
            # like any exception, degrades the batch to one-at-a-time runs
            with contextlib.redirect_stdout(diag):
                results = run_plans_banked_pipelined(
                    [(p, a, r) for _i, p, a, r in jobs], depth=1,
                    device=from_env())
            if diag.getvalue():
                results = None
        except Exception:  # noqa: BLE001 - retry one at a time
            results = None
        if results is None:
            for i, _p, _a, _r in jobs:
                outputs[i] = _one(*requests[i])
        else:
            # the batch decodes jointly: each request reports the batch's
            # average wall time
            elapsed = round((time.time() - start) / len(jobs), 2)
            for (i, plan, _a, _r), result in zip(jobs, results):
                out = [f"Built {len(plan.chains)} demod chains\n",
                       f"banked runtime: {len(plan.chains)} chains\n"]
                for report_spec, text in zip(plan.reports, result.reports):
                    out.append(f"Generating {report_spec.name}\n")
                    out.append(text + "\n")
                out.append(f"Elapsed time: {elapsed} seconds.\n")
                outputs[i] = (0, "".join(out))
    return [o if o is not None else (1, "internal error\n") for o in outputs]


def run_decode(config_path: str, wav_path: str) -> int:
    """Validate inputs, run the plan on the runtime PYMODEM_TPU_TORCH_RUNTIME
    names, print reports.  Shared by the one-shot CLI and the server."""
    from . import profiling
    from .config import load_plan
    from .device import DeviceLostError, from_env
    from .wav_io import read_wav

    if runtime_name() == "banked":
        from .runtime.bank import run_plan_banked as run_plan
    else:
        from .runtime.executor import run_plan

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
    profile = _env("PROFILE")
    if profile:
        profiling.enable()
    print(f"Built {len(plan.chains)} demod chains")
    start = time.time()
    trace_dir = profile if profile not in ("", "1", "true", "yes") else None
    try:
        with profiling.trace(trace_dir):
            result = run_plan(plan, audio, sample_rate, verbose=True,
                              device=device)
    except DeviceLostError:  # the runtime has named the error
        return 1
    for report_spec, text in zip(plan.reports, result.reports):
        print(f"Generating {report_spec.name}")
        print(text)
    if profile:
        print(profiling.report())
    print(f"Elapsed time: {round(time.time() - start, 2)} seconds.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
