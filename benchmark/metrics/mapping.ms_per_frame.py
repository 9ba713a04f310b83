"""Mapping's host ms per frame: Telemetry.mapping_ms (the synchronous
LocalMapper drain and the LoopCloser) over the window's frames."""

from harness.layers import telemetry_ms_per_frame


def read(ctx):
    return telemetry_ms_per_frame(ctx, "mapping_ms")
