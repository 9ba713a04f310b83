"""The readers of the program's spans on made-up telemetry and traces: the
per-frame means over the untraced frames, launches counted inside the pose
LMs' spans, and the idle time that no span names."""

import pytest

import bench_support
from harness import spans
from harness.cell import RunContext
from harness.registry import Registry
from harness.tracing import Trace

READ = Registry(bench_support.REPO).metric_reader


def _trace(device_ops, host_ops, window_s=1.0, frames=2):
    return Trace(device_ops, host_ops, 0, int(window_s * 1e9), 0, frames)


def _ctx(telemetry=(), trace=None, traced_range=(0, 0), n_cams=1):
    return RunContext(telemetry=list(telemetry), trace=trace,
                      traced_range=traced_range, n_cams=n_cams)


def test_span_ms_per_frame_counts_zero_where_the_span_did_not_run():
    recs = [{"spans": {"track.pose_lm": [30.0, 2], "track.fetch": [1.0, 3]}},
            {"spans": {"track.fetch": [2.0, 1]}},
            # The traced frame (index 2) is left out.
            {"spans": {"track.pose_lm": [900.0, 2]}},
            {"spans": {"track.pose_lm": [60.0, 2], "mapping.local_ba": [8.0, 1]}}]
    ctx = _ctx([recs], traced_range=(2, 3))
    assert READ("track.pose_lm_ms_per_frame")(ctx) == pytest.approx(30.0)
    assert READ("track.fetch_wait_ms_per_frame")(ctx) == pytest.approx(1.0)
    assert READ("mapping.local_ba_ms_per_frame")(ctx) == pytest.approx(8.0 / 3)
    assert READ("mapping.tri_fuse_ms_per_frame")(ctx) == 0.0
    assert READ("track.extract_ms_per_frame")(ctx) == 0.0


def test_span_readers_find_nothing_in_a_program_without_spans():
    recs = [{"track_ms": 10.0, "mapping_ms": 0.0}] * 4
    host = [("aten::add", 0.1, 0.2), ("cudaLaunchKernel", 0.1, 0.11)]
    ctx = _ctx([recs], trace=_trace([("k", 0.1, 0.2)], host))
    for name in ("track.extract_ms_per_frame", "track.pose_lm_ms_per_frame",
                 "track.fetch_wait_ms_per_frame", "mapping.local_ba_ms_per_frame",
                 "mapping.tri_fuse_ms_per_frame",
                 "track.pose_lm_launches_per_frame", "device.idle_outside_spans"):
        assert READ(name)(ctx) is None, name


def test_launches_are_counted_inside_the_pose_lm_spans_only():
    host = [("system.frame", 0.0, 0.9),
            ("track.pose_lm", 0.10, 0.20), ("track.pose_lm", 0.15, 0.25),
            ("track.pose_lm", 0.50, 0.60),
            ("cudaLaunchKernel", 0.12, 0.121),      # inside the first two
            ("cudaLaunchKernel", 0.22, 0.221),      # inside the second only
            ("cuLaunchKernel", 0.55, 0.551),
            ("cudaGraphLaunch", 0.60, 0.601),       # at the span's end
            ("cudaLaunchKernel", 0.30, 0.301),      # between spans
            ("cudaLaunchKernel", 0.05, 0.051),      # before every span
            ("aten::add", 0.11, 0.13),              # not a launch
            ("cudaMemcpyAsync", 0.52, 0.53)]
    t = _trace([], host, frames=2)
    iv = spans.span_intervals(t, names=("track.pose_lm",))
    assert spans.launches_inside(t, iv) == 4
    assert READ("track.pose_lm_launches_per_frame")(_ctx(trace=t)) == 2.0
    assert READ("track.pose_lm_launches_per_frame")(
        _ctx(trace=t, n_cams=2)) == 1.0


def test_idle_outside_spans_is_the_idle_time_no_span_covers():
    # Window 1 s; the card busy [0.1, 0.2] and [0.5, 0.6]: 0.8 s idle.
    dev = [("k1", 0.1, 0.2), ("k2", 0.5, 0.6)]
    # Spans cover [0.0, 0.3] and [0.4, 0.7] (nested ones inside), and a
    # device-only name or an aten op is no span.
    host = [("system.frame", 0.0, 0.3), ("track.pose_lm", 0.05, 0.25),
            ("mapping.local_ba", 0.4, 0.7), ("loop.fetch", 0.45, 0.46),
            ("aten::add", 0.75, 0.95), ("bench.other", 0.8, 0.9)]
    t = _trace(dev, host)
    # Idle outside spans: [0.3, 0.4] and [0.7, 1.0] = 0.4 s of 0.8 s.
    assert READ("device.idle_outside_spans")(_ctx(trace=t)) == pytest.approx(50.0)
    assert spans.idle_outside_share(1.0, [(s, e) for _n, s, e in dev],
                                    [(0.0, 1.0)]) == pytest.approx(0.0)
    assert spans.idle_outside_share(1.0, [(s, e) for _n, s, e in dev],
                                    [(0.15, 0.55)]) == pytest.approx(
        100.0 * (0.8 - 0.3) / 0.8)
    # Intervals past the window's ends are cut to it; no idle time: None.
    assert spans.idle_outside_share(1.0, [(-0.5, 0.5)], [(0.9, 1.5)]) == \
        pytest.approx(80.0)
    assert spans.idle_outside_share(1.0, [(0.0, 1.0)], [(0.2, 0.3)]) is None
