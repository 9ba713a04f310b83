"""The traffic generator renders a seed's frames the same whenever the run
reaches them, and never hands out a frame it has not rendered. A rig's
second stream comes from the same ground (a right view at disparity bf / z,
a depth image of the plane) and leaves the first stream's bytes as they
were."""

import hashlib
import json
import os

import numpy as np
import pytest

import bench_support
from harness import scene
from harness.registry import Registry


def _stream(seed):
    b = bench_support.BENCH
    with open(os.path.join(b, "traffic", "explore.json")) as f:
        traffic = json.load(f)
    cam = {"fx": 129.3, "fy": 129.1, "cx": 79.6, "cy": 63.8, "width": 160,
           "height": 128, "fps": 30.0, "k1": 0.26, "k2": -0.95, "p1": -0.005,
           "p2": 0.003, "k3": 1.16}
    poses, _seg = scene.camera_path(traffic, cam, 1, seed)
    r = scene.Renderer(cam, traffic, poses, scene.seed_generator(seed, "cpu"), "cpu")
    return scene.FrameStream(r, poses, chunk=8)


def test_frames_do_not_depend_on_when_they_are_rendered():
    a, b = _stream(4000000001), _stream(4000000001)
    a.render_to(3)
    assert a.ready == 8
    a.render_to(20)
    b.render_to(20)
    assert a.ready == b.ready == 24
    assert np.array_equal(a.frames[:24], b.frames[:24])
    assert a[23].std() > 10
    c = _stream(4000000003)
    c.render_to(1)
    assert not np.array_equal(a[0], c[0])


def test_a_frame_not_rendered_is_not_handed_out():
    s = _stream(4000000001)
    with pytest.raises(IndexError):
        s[0]
    s.render_to(len(s) + 100)
    assert s.ready == len(s)
    with pytest.raises(IndexError):
        s[len(s)]


# The first four frames of tum1_mono's camera at seed 4000000011 (camera 0)
# over a 2 s window, rendered on the CPU by the generator as it stood before
# the scene learned rigs: a rig may add streams, never move these bytes.
PINNED = {
    "explore": "2b8c19a083788a6095cecf5663cc4dc083cea6cf00a4ce2ec41b23cb10a3e6f8",
    "localize": "f553797f887a62af9192493a3fec26c0a902e906c0494124bade936590ba0392",
}


@pytest.mark.parametrize("traffic_name", sorted(PINNED))
def test_tum1_frames_match_their_pinned_hash(traffic_name):
    reg = Registry(bench_support.REPO)
    cfg = reg.config("tum1_mono")
    _poses, _seg, streams = scene.camera_streams(
        cfg, reg.traffic(traffic_name), 2, 4000000011 * 16, "cpu")
    assert len(streams) == 1
    streams[0].chunk = 4
    streams[0].render_to(4)
    digest = hashlib.sha256(streams[0].frames[:4].tobytes()).hexdigest()
    assert digest == PINNED[traffic_name]


def _rig(tmp_path, sensor):
    """The tiny rig's configuration and traffic (tests/bench_support.py), and
    the same camera without the sensor's keys: a monocular configuration."""
    reg = Registry(bench_support.make_root(tmp_path, sensor=sensor))
    cfg = reg.config(f"tiny_{sensor}")
    mono = {k: v for k, v in cfg.items()
            if k not in ("sensor", "th_depth", "depth_map_factor")}
    mono["camera"] = {k: v for k, v in cfg["camera"].items() if k != "bf"}
    return cfg, mono, reg.traffic("tiny_explore")


def _ground_z(T, x, y):
    """Camera-frame z where the ray of normalized undistorted point (x, y)
    of the camera Tcw meets the ground z = 0."""
    Rwc = T[:3, :3].T
    C = -Rwc @ T[:3, 3]
    d = Rwc @ np.array([x, y, 1.0])
    return -C[2] / d[2]


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_a_rigs_left_view_is_the_monocular_view(tmp_path, sensor):
    cfg, mono, traffic = _rig(tmp_path, sensor)
    seed = 4000000021
    _p, _s, rig = scene.camera_streams(cfg, traffic, 1, seed, "cpu")
    _p, _s, alone = scene.camera_streams(mono, traffic, 1, seed, "cpu")
    assert len(rig) == 2 and len(alone) == 1
    for fs in rig + alone:
        fs.chunk = 4
        fs.render_to(4)
    assert np.array_equal(rig[0].frames[:4], alone[0].frames[:4])
    assert rig[1].frames.dtype == (np.uint8 if sensor == "stereo" else np.uint16)


def test_a_ground_points_disparity_is_bf_over_z(tmp_path):
    cfg, _mono, traffic = _rig(tmp_path, "stereo")
    cam = cfg["camera"]
    poses, _s, (left, right) = scene.camera_streams(cfg, traffic, 1, 4000000031, "cpu")
    for fs in (left, right):
        fs.chunk = 2
        fs.render_to(1)
    L, R = left[0].astype(np.float64), right[0].astype(np.float64)
    half_r, half_c = 3, 7
    for v in range(40, 201, 40):
        for u in range(110, 231, 40):
            z = _ground_z(poses[0], (u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"])
            want = cam["bf"] / z
            assert 20.0 <= want <= 60.0
            win = L[v - half_r:v + half_r + 1, u - half_c:u + half_c + 1]
            sad = np.array([np.abs(win - R[v - half_r:v + half_r + 1,
                                           u - d - half_c:u - d + half_c + 1]).sum()
                            for d in range(10, 80)])
            k = int(np.argmin(sad))
            a, b, c = sad[k - 1], sad[k], sad[k + 1]
            got = 10 + k + 0.5 * (a - c) / (a - 2 * b + c)
            assert abs(got - want) < 0.5, (u, v, got, want)


def _distort(cam, x, y):
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam["k1"] + r2 * (cam["k2"] + r2 * cam["k3"]))
    xd = x * radial + 2 * cam["p1"] * x * y + cam["p2"] * (r2 + 2 * x * x)
    yd = y * radial + cam["p1"] * (r2 + 2 * y * y) + 2 * cam["p2"] * x * y
    return cam["fx"] * xd + cam["cx"], cam["fy"] * yd + cam["cy"]


def test_the_depth_image_is_the_planes_depth(tmp_path):
    cfg, _mono, traffic = _rig(tmp_path, "rgbd")
    cam, f = cfg["camera"], cfg["depth_map_factor"]
    assert cam["k1"] != 0.0
    poses, _s, (_colour, depth) = scene.camera_streams(cfg, traffic, 1, 4000000041, "cpu")
    depth.chunk = 2
    depth.render_to(1)
    D = depth[0].astype(np.float64)
    T = poses[0]
    rng = np.random.default_rng(7)
    checked = 0
    for x, y in rng.uniform([-0.5, -0.4], [0.5, 0.4], (200, 2)):
        u, v = _distort(cam, x, y)
        if not (1 <= u < cam["width"] - 2 and 1 <= v < cam["height"] - 2):
            continue
        u0, v0 = int(u), int(v)
        a, b = u - u0, v - v0
        got = ((1 - a) * (1 - b) * D[v0, u0] + a * (1 - b) * D[v0, u0 + 1]
               + (1 - a) * b * D[v0 + 1, u0] + a * b * D[v0 + 1, u0 + 1])
        assert abs(got - _ground_z(T, x, y) * f) <= 1.0, (x, y, got)
        checked += 1
    assert checked > 100
    # Tilted towards the horizon: rays that miss the ground read 0.
    up = np.array(T)
    up[:3, :3] = np.array([[1.0, 0, 0], [0, np.cos(1.4), np.sin(1.4)],
                           [0, -np.sin(1.4), np.cos(1.4)]]) @ up[:3, :3]
    far = depth.renderer.depth([up], f)[0].numpy()
    assert (far[0] == 0).all() and (far[-1] > 0).all()


def test_a_view_past_the_grounds_edge_fails(tmp_path):
    cfg, _mono, traffic = _rig(tmp_path, "stereo")
    b = cfg["camera"]["bf"] / cfg["camera"]["fx"]
    with pytest.raises(ValueError, match="footprint_m"):
        scene.camera_streams(cfg, dict(traffic, footprint_m=b), 1, 4000000051, "cpu")
    # The baseline fits, but the ground ends before the views' edges do.
    _p, _s, streams = scene.camera_streams(cfg, dict(traffic, footprint_m=1.5 * b), 1,
                                           4000000051, "cpu")
    with pytest.raises(RuntimeError, match="outside"):
        streams[1].render_to(1)
