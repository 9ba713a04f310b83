"""Launches per traced frame inside the pose LMs: the host's launch calls
(cudaLaunchKernel and the like, cudaGraphLaunch counted once) that start
inside a track.pose_lm span of the traced sub-window."""

from harness.spans import launches_inside, span_intervals


def read(ctx):
    t = ctx.trace
    iv = span_intervals(t, names=("track.pose_lm",))
    if not iv:
        return None
    return launches_inside(t, iv) / (t.frames * ctx.n_cams)
