"""Reduction of a ``torch.profiler`` run, kept in memory, to what the
per-layer readers and the result's ``device`` and ``breakdown`` take:
device operations (kernels, copies, sets) and host events on one clock,
the device's busy time, and the longest device idle gaps labelled by what
the host was doing."""

from __future__ import annotations

import bisect
from dataclasses import dataclass


@dataclass(frozen=True)
class Event:
    name: str
    start: int  # ns
    end: int  # ns
    # the profiler's correlation ids: a host event's own, and a device
    # operation's own and that of the host event that launched it
    corr: int = 0
    linked: int = 0
    thread: int = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


# what ran on the device; a range of record_function has a device-side
# twin (gpu_user_annotation) that is no operation
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def events(prof, window: str) -> tuple[list[Event], list[Event], Event]:
    """(device events, host events, the window's own range) of a finished
    profiler, clipped to the range named ``window``."""
    dev, host, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), int(e.start_ns()),
                   int(e.start_ns()) + int(e.duration_ns()),
                   int(e.correlation_id()), int(e.linked_correlation_id()),
                   int(e.start_thread_id()))
        if str(e.device_type()).endswith("CUDA"):
            kind = getattr(e, "activity_type", None)
            if kind is None or kind() in DEVICE_OPS:
                dev.append(ev)
        else:
            host.append(ev)
            if ev.name == window:
                span = ev
    # where torch's event has no activity type, a range's device-side twin
    # is told by its name, which a host range carries too (no kernel or
    # copy is named as a host event)
    ranges = {e.name for e in host}
    dev = [e for e in dev if e.name not in ranges]
    if span is None:
        raise RuntimeError(f"no {window!r} range in the trace")
    inside = [e for e in dev if e.start >= span.start and e.end <= span.end]
    return inside, host, span


def launched_within(dev: list[Event], host: list[Event],
                    span: str) -> list[Event]:
    """The device operations whose launch, on the host, lies inside a
    range named ``span`` on the same thread: each operation is traced to
    the host event that launched it by the profiler's correlation id."""
    ranges: dict[int, list[tuple[int, int]]] = {}
    for e in host:
        if e.name == span:
            ranges.setdefault(e.thread, []).append((e.start, e.end))
    for r in ranges.values():
        r.sort()
    starts = {t: [a for a, _ in r] for t, r in ranges.items()}
    launch = {e.corr: e for e in host if e.corr and e.name != span}

    def inside(h: Event) -> bool:
        # the spans of one thread do not nest: the last to start before
        # the launch is the only one that can hold it
        k = bisect.bisect_right(starts.get(h.thread, []), h.start) - 1
        return k >= 0 and h.start <= ranges[h.thread][k][1]

    out = []
    for e in dev:
        h = launch.get(e.linked) or launch.get(e.corr)
        if h is not None and inside(h):
            out.append(e)
    return out


def busy_intervals(dev: list[Event]) -> list[tuple[int, int]]:
    """The union of the device events' intervals, in order."""
    out: list[list[int]] = []
    for e in sorted(dev, key=lambda e: e.start):
        if out and e.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.end)
        else:
            out.append([e.start, e.end])
    return [(a, b) for a, b in out]


def busy_seconds(dev: list[Event]) -> float:
    return sum(b - a for a, b in busy_intervals(dev)) * 1e-9


def top_ops(dev: list[Event], n: int = 10) -> list[list]:
    """The device operations that took most time, summed by name."""
    total: dict[str, int] = {}
    for e in dev:
        total[e.name] = total.get(e.name, 0) + (e.end - e.start)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns * 1e-9] for name, ns in ranked]


def _label(host: list[Event], t: int) -> str:
    """What the host was doing at time t: the innermost benchmark span and
    the innermost other host event around t."""
    around = [e for e in host if e.start <= t <= e.end]
    spans = [e for e in around if e.name.startswith("portbench.")
             and e.name != "portbench.window"]
    other = [e for e in around if not e.name.startswith("portbench.")]
    parts = []
    if spans:
        parts.append(max(spans, key=lambda e: e.start).name)
    if other:
        parts.append(max(other, key=lambda e: e.start).name)
    return " / ".join(parts) or "host, untraced"


def idle_gaps(dev: list[Event], host: list[Event], span: Event,
              n: int = 10) -> list[list]:
    """The n longest device idle gaps in the window, labelled."""
    gaps, last = [], span.start
    for a, b in busy_intervals(dev):
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if span.end > last:
        gaps.append((last, span.end))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[_label(host, (a + b) // 2), (b - a) * 1e-9] for a, b in gaps[:n]]
