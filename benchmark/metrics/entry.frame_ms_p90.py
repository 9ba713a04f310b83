"""entry.frame_ms_p90: the 90th percentile (nearest rank) of every timed
window frame's hand-in-to-pose time, in ms, as the end-to-end frame_ms_p90
was read before the host's speed made it too unsteady for any bound allowed
(PERF.md section 2)."""

from harness import stats


def read(ctx):
    if not ctx.latencies:
        return None
    return 1e3 * stats.nearest_rank(ctx.latencies, 0.9)
