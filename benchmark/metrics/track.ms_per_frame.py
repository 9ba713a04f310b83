"""Tracking's host ms per frame: Telemetry.track_ms (Tracker, FrameBuilder,
the device tracking steps and the pose solver) over the window's frames."""

from harness.layers import telemetry_ms_per_frame


def read(ctx):
    return telemetry_ms_per_frame(ctx, "track_ms")
