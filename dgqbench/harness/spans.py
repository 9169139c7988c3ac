"""What the program itself records while a traced slice runs: its span
counters (`dgq_tpu_torch.utils.profiler.device_counters`), read by the
per-layer metrics that name the program's spans. A program without them
gives nothing to read, and those metrics read None.

A device counter is a stream extent: from an event the span records on the
stream at its start to one at its end. Under the profiler the host is
slower and the device waits inside many spans, so an extent alone counts
that wait. `busy_ms_per` takes it out: while the device is idle it has
finished everything queued before, so an idle gap that overlaps the span's
host interval (the span as a CPU operation on the profiler's clock) lies
inside its extent, and every idle moment of the extent is such an overlap.
For spans of one name that do not nest, extent minus overlap is the
device's busy time inside them, up to the launch latency at each span's
start and the two clocks' alignment: the difference of two large numbers
(the extents hold 1.3x to 3.5x the busy time under the profiler), so it
swings by a sixth from run to run. Kineto's correlation ids would put each
device operation under its span exactly; the harness's `Session` does not
keep them yet.

Spans inside a `<per>.untimed` span (the program's every second UNet call)
time no extent: they are left out of the idle taken out and of the count
divided by.
"""
from __future__ import annotations


def device_counters() -> dict:
    """{span name: (spans, device ms or None)}, or {} where the program
    keeps no such counters."""
    try:
        from dgq_tpu_torch.utils.profiler import device_counters as counters
    except ImportError:
        return {}
    return counters()


def intervals(session, name: str) -> list:
    """(start, end) ns of the host spans `name` in the session."""
    return [(a, b) for n, a, b in session.host_ops if n == name]


def idle_inside_ns(sessions, name: str, skip: str | None = None) -> int:
    """Idle ns of the device that overlap the host intervals of the spans
    `name`, over the sessions, leaving out the spans that lie inside a span
    `skip`."""
    total = 0
    for s in sessions:
        out = intervals(s, skip) if skip else []
        spans = [(a, b) for a, b in intervals(s, name)
                 if not any(x <= a and b <= y for x, y in out)]
        gaps, i = s.gaps(), 0
        for a, b in spans:
            while i < len(gaps) and gaps[i][1] <= a:
                i += 1
            j = i
            while j < len(gaps) and gaps[j][0] < b:
                total += min(b, gaps[j][1]) - max(a, gaps[j][0])
                j += 1
    return total


def busy_ms_per(sessions, name: str, per: str | None = None):
    """The device's busy ms inside the timed spans `name` (their summed
    extents less the idle inside them) over the number of timed spans `per`
    (`name` itself by default), or None where either is missing or was not
    timed on a card."""
    c = device_counters()
    per = per or name
    untimed = per + ".untimed"
    timed = c.get(per, (0,))[0] - c.get(untimed, (0,))[0]
    if name not in c or c[name][1] is None or timed <= 0:
        return None
    return (c[name][1] - idle_inside_ns(sessions, name, skip=untimed) / 1e6) / timed
