"""Triangulation and fusion's host ms per frame: the span mapping.tri_fuse
(prep, the fused device step and its fetch, merge) in the window's
telemetry."""

from harness.spans import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "mapping.tri_fuse")
