"""Shared arithmetic of the per-layer metric readers."""

from __future__ import annotations


def telemetry_ms_per_frame(ctx, field: str):
    """The window's sum of one Telemetry field (host ms, each span ending
    in a device fetch) over its frames, per frame; the profiled frames are
    left out, since the profiler slows the host."""
    lo, hi = ctx.traced_range
    total, n = 0.0, 0
    for records in ctx.telemetry:
        for k, r in enumerate(records):
            if not lo <= k < hi:
                total += float(r[field])
                n += 1
    return total / n if n else None
