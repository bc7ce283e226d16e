"""Tracing and stage timing.

Port of ``pymodem_tpu.profiling``.  ``timed()`` collects named stage wall
times and call counts that ``report()`` renders, and opens a
``torch.profiler`` range ``pymodem.<name>`` around its body, so every
stage lies on the profiler's clock beside the CUDA activity it launches
or waits for; ``count()`` adds to a named counter without a time (the
device codec counts its host-fallback blocks with it); ``trace()`` wraps
a region in a ``torch.profiler`` trace written as a Chrome trace.  While
enabled, each collection of Python's garbage collector is a ``gc`` stage
and a ``pymodem.gc`` range.  Nothing is collected, and torch is not
called, unless ``enable()`` was called.

Stage times are host wall clock: a CUDA launch returns before the card
finishes, so a device stage's time lands in the first stage that waits
for it (a readback, ``host_wait``).  The ranges never synchronise the
stream; a trace gives the device time of what a range launched.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from collections import defaultdict

_STAGES: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
ENABLED = False
# torch.profiler.record_function, bound by the first enable(): a gc
# callback must not be the first to import torch
_RANGE = None
# (range, start) of the collection under way while enabled
_GC_OPEN: list = []


def _gc_hook(phase: str, _info: dict) -> None:
    """``gc.callbacks`` entry while enabled: each collection a ``gc``
    stage and a ``pymodem.gc`` range, so a pause is not charged to the
    span it interrupts."""
    if phase == "start":
        rng = _RANGE("pymodem.gc")
        rng.__enter__()
        _GC_OPEN[:] = [rng, time.perf_counter()]
    elif _GC_OPEN:
        rng, t0 = _GC_OPEN
        _STAGES["gc"] += time.perf_counter() - t0
        _COUNTS["gc"] += 1
        rng.__exit__(None, None, None)
        _GC_OPEN.clear()


def enable(flag: bool = True) -> None:
    global ENABLED, _RANGE
    if flag and _RANGE is None:
        from torch.profiler import record_function

        _RANGE = record_function
    ENABLED = flag
    if flag and _gc_hook not in gc.callbacks:
        gc.callbacks.append(_gc_hook)
    elif not flag and _gc_hook in gc.callbacks:
        gc.callbacks.remove(_gc_hook)


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
def timed(name: str, args: object = None):
    """Stage ``name`` around the body: its wall time and a call, and a
    ``torch.profiler`` range ``pymodem.<name>`` carrying ``str(args)``
    (the spans of one job share it)."""
    if not ENABLED:
        yield
        return
    with _RANGE(f"pymodem.{name}", None if args is None else str(args)):
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
    """The stage table, slowest first, then every counter that is no
    stage."""
    counters = {k: n for k, n in _COUNTS.items() if k not in _STAGES}
    lines = []
    if _STAGES:
        width = max(len(k) for k in _STAGES)
        lines.append("stage timings:")
        for name, total in sorted(_STAGES.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"  {name:<{width}}  {total:8.3f}s  ({_COUNTS[name]} calls)"
            )
    if counters:
        width = max(len(k) for k in counters)
        lines.append("counters:")
        for name, n in sorted(counters.items()):
            lines.append(f"  {name:<{width}}  {n}")
    return "\n".join(lines)
