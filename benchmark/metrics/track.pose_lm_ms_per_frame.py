"""The pose LMs' host ms per frame: the span track.pose_lm (every pose-LM
call of tracking) in the window's telemetry."""

from harness.spans import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "track.pose_lm")
