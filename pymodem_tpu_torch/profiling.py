"""Tracing and stage timing.

Port of ``pymodem_tpu.profiling``.  ``timed()`` collects named stage wall
times and call counts that ``report()`` renders; ``count()`` adds to a
named counter without a time (the device codec counts its host-fallback
blocks with it); ``trace()`` wraps a region in a ``torch.profiler`` trace
written as a Chrome trace.  Nothing is collected unless ``enable()`` was
called.

Stage times are host wall clock: a CUDA launch returns before the card
finishes, so a device stage's time lands in the first stage that waits
for it (a readback).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

_STAGES: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
ENABLED = False


def enable(flag: bool = True) -> None:
    global ENABLED
    ENABLED = flag


def reset() -> None:
    """Clear collected stage timings and counts (tests assert on counts)."""
    _STAGES.clear()
    _COUNTS.clear()


def counts() -> dict[str, int]:
    return dict(_COUNTS)


def stages() -> dict[str, float]:
    """Seconds collected per stage name."""
    return dict(_STAGES)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (no time)."""
    if ENABLED:
        _COUNTS[name] += n


@contextlib.contextmanager
def timed(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STAGES[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler trace around a region (host and, on CUDA, device
    timelines), written to ``log_dir/trace.json``."""
    if not log_dir:
        yield
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def report() -> str:
    if not _STAGES:
        return ""
    width = max(len(k) for k in _STAGES)
    lines = ["stage timings:"]
    for name, total in sorted(_STAGES.items(), key=lambda kv: -kv[1]):
        lines.append(
            f"  {name:<{width}}  {total:8.3f}s  ({_COUNTS[name]} calls)"
        )
    return "\n".join(lines)
