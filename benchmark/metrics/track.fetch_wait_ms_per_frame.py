"""Tracking's wait for the card per frame: the span track.fetch (every
blocking device-to-host copy of tracking, and the pipelined chain's event
wait) in the window's telemetry."""

from harness.spans import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "track.fetch")
