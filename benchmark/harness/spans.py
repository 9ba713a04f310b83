"""Readers of the program's spans (the port's utils/metrics.py): each
frame's telemetry record carries `spans`, {name: [host ms, calls]}, and
under the profiler each span is a host range (a CPU operation) named
`<layer>.<stage>` on the trace's clock. A program without spans gives
these readers nothing, and they return None."""

from __future__ import annotations

import bisect

from harness.stats import merged, union_seconds
from harness.tracing import _LAUNCH_CALLS

PREFIXES = ("system.", "track.", "mapping.", "loop.")
# Every host call that launches device work; a CUDA graph is one launch.
LAUNCHES = frozenset(_LAUNCH_CALLS + ("cudaGraphLaunch", "cuGraphLaunch"))


def span_ms_per_frame(ctx, name: str):
    """The span's host ms per frame: its ms in each record of the window's
    untraced frames (0 where it did not run), averaged over those frames;
    None where no record carries spans."""
    lo, hi = ctx.traced_range
    total, n = 0.0, 0
    for records in ctx.telemetry:
        for k, r in enumerate(records):
            spans = r.get("spans")
            if lo <= k < hi or spans is None:
                continue
            entry = spans.get(name)
            total += float(entry[0]) if entry else 0.0
            n += 1
    return total / n if n else None


def span_intervals(trace, names=None, prefixes=PREFIXES) -> list:
    """(start_s, end_s) of the trace's program spans: those named in
    `names`, else those whose name starts with one of `prefixes`."""
    if trace is None:
        return []
    if names is not None:
        return [(s, e) for n, s, e in trace.host_ops if n in names]
    return [(s, e) for n, s, e in trace.host_ops if n.startswith(prefixes)]


def launches_inside(trace, intervals) -> int:
    """Launch calls on the host that start inside one of the intervals."""
    iv = merged(intervals)
    starts = [s for s, _e in iv]
    count = 0
    for n, s, _e in trace.host_ops:
        if n in LAUNCHES:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= iv[i][1]:
                count += 1
    return count


def idle_outside_share(window_s: float, device, spans):
    """Of the window's device-idle time (the window less the union of the
    device intervals), the share, in %, during which no span was open; None
    where the window has no idle time. Intervals are cut to the window."""
    def cut(iv):
        return [(max(s, 0.0), min(e, window_s)) for s, e in iv
                if e > 0.0 and s < window_s]
    device = cut(device)
    idle = window_s - union_seconds(device)
    if idle <= 0.0:
        return None
    outside = window_s - union_seconds(device + cut(spans))
    return 100.0 * outside / idle
