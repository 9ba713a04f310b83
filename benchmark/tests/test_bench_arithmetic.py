"""The benchmark's arithmetic: the tail, the interval union, the spread,
and kernels A and B's counts against PERF.md's computed bounds at 640x480."""

import numpy as np
import pytest
import torch

import bench_support  # noqa: F401  (puts the benchmark on sys.path)
from harness import roofline, stats


def test_p90_has_ten_beyond_it_at_a_hundred_frames():
    xs = list(range(1, 101))
    assert stats.nearest_rank(xs, 0.9) == 90
    assert stats.beyond(100, 0.9) == 10
    assert stats.beyond(99, 0.9) == 9
    assert stats.nearest_rank(xs[::-1], 0.9) == 90


@pytest.mark.parametrize("q,expect", [(0.5, 3), (0.9, 5), (0.2, 1)])
def test_nearest_rank_small(q, expect):
    assert stats.nearest_rank([5, 1, 4, 2, 3], q) == expect


def test_union_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 10.5)]
    assert stats.union_seconds(iv) == pytest.approx(3.5)
    assert stats.merged(iv) == [(0.0, 2.0), (3.0, 4.0), (10.0, 10.5)]
    assert stats.union_seconds([]) == 0.0


class _Reg:
    def __init__(self):
        from harness.registry import Registry
        self.kernel = Registry(bench_support.REPO).kernel


def _perf_frame():
    """kernel_times.py's frame: frame 0 of its 640x480 orbit."""
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    W, H = 640, 480
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1]])
    r = PlanarSceneRenderer(K, W, H, texture=make_texture(2048, 8, 7),
                            tex_scale=440.0)
    T0 = orbit_trajectory(30, radius=0.35, depth=-2.0, tilt=0.3)[0]
    return np.clip(r.render(T0), 0, 255).astype(np.uint8)[None]


CFG = {"orb": {"n_features": 1000, "scale_factor": 1.2, "n_levels": 8,
               "ini_th_fast": 20, "min_th_fast": 7}}


def test_kernel_a_bound_is_perf_md_bytes_bound_at_640x480():
    k = _Reg().kernel("fast_score_nms")
    n_bytes, n_ops = k.count(np.zeros((1, 480, 640), np.uint8), CFG, "cpu")
    assert n_bytes == 8.0 * 950532
    # PERF.md section 6: bytes 0.0023 ms; 122 operations a pixel take less.
    assert 1e3 * roofline.bound_s(n_bytes, n_ops) == pytest.approx(0.00227, abs=5e-6)
    assert n_ops / roofline.F32_OPS_PER_S < n_bytes / roofline.HBM_BYTES_PER_S


def test_kernel_b_bound_is_perf_md_describe_bound_at_640x480():
    torch.set_num_threads(2)
    k = _Reg().kernel("gather_blur_describe")
    n_bytes, n_ops = k.count(_perf_frame(), CFG, "cpu")
    # PERF.md section 6: 686,810 of the canvas's floats in the keypoints'
    # windows, bound 0.00084 ms (bytes).
    assert n_bytes == 4.0 * (686810 + 2 * 1024 + 11 * 1024)
    assert 1e3 * roofline.bound_s(n_bytes, n_ops) == pytest.approx(0.00084, abs=5e-6)


def test_end_to_end_readings_of_a_window():
    """kernel_ms_per_frame is the meter's kernel seconds over every window
    frame; the host-clock readings are as before."""
    import io
    from types import SimpleNamespace
    from harness import cell
    meter = SimpleNamespace(kernel_s=0.75)
    log = io.StringIO()
    lat = [0.01 * k for k in range(1, 101)]
    assert cell.end_to_end("kernel_ms_per_frame", 250, 51.0, lat, 30.0, log,
                           meter) == pytest.approx(3.0)
    assert cell.end_to_end("fps", 250, 50.0, lat, 30.0, log) == pytest.approx(5.0)
    assert cell.end_to_end("frame_ms_p90", 250, 50.0, lat, 30.0, log) == pytest.approx(900.0)
    assert cell.end_to_end("setup_s", 250, 50.0, lat, 30.0, log) == 30.0


def test_entry_readers_match_the_end_to_end_arithmetic():
    from types import SimpleNamespace
    from harness.registry import Registry
    reg = Registry(bench_support.REPO)
    lat = [0.01 * k for k in range(1, 101)]
    ctx = SimpleNamespace(frames=250, window_s=50.0, latencies=lat)
    assert reg.metric_reader("entry.fps")(ctx) == pytest.approx(5.0)
    assert reg.metric_reader("entry.frame_ms_p90")(ctx) == pytest.approx(900.0)
    empty = SimpleNamespace(frames=0, window_s=0.0, latencies=[])
    assert reg.metric_reader("entry.fps")(empty) is None
    assert reg.metric_reader("entry.frame_ms_p90")(empty) is None
