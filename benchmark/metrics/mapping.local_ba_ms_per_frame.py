"""Local BA's host ms per frame: the span mapping.local_ba (prep, the
device solve and its fetch, write-back) in the window's telemetry."""

from harness.spans import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "mapping.local_ba")
