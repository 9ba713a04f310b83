"""Frame construction's host ms per frame: the span track.extract
(FrameBuilder.build / build_stereo / build_rgbd / extract_packed_batch:
upload, pyramid, kernels A and B, packing) in the window's telemetry."""

from harness.spans import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "track.extract")
