"""The port's viewer and AR overlay (models/viewer.py, models/ar.py) on the
CPU against the JAX package's (tests/test_viewer_ar.py's cases): the same
numpy inputs give equal arrays, strings and files.

* fit_plane (same rng data), cube_vertices and draw_cube: equal outputs.
* annotate_frame without and with a VO mask and with the initialization
  overlay: equal u8 images; status_text: equal strings.
* export_map_ply of two arenas built from the same keyframes and points:
  equal text.
* The bounded _line: a segment with ends 1e9 px outside the image draws in
  at most max(W, H) + 1 samples (the JAX _line would take 2e9), and every
  segment inside the image draws the JAX _line's pixels; the same for the
  AR module's _draw_line.
* LiveViewer on the port System (use_viewer, port 0) over 14 frames of the
  320x240 orbit: it serves the page, the frame, the status, the map JSON
  and the PLY, updates once per frame in the pipelined mode too, and its
  menu toggles localization mode, inserts and clears an AR cube and
  resets the System (tests/test_viewer_ar.py's last case).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from orb_slam_system_tpu.config import TrackingState as JTrackingState
from orb_slam_system_tpu.mapping import arena as jarena
from orb_slam_system_tpu.models import ar as jar
from orb_slam_system_tpu.models import viewer as jviewer
from orb_slam_system_tpu_torch.config import TrackingState
from orb_slam_system_tpu_torch.mapping import arena
from orb_slam_system_tpu_torch.models import ar, viewer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plane_points(rng):
    pts = rng.uniform(-2, 2, size=(200, 3)).astype(np.float32)
    pts[:, 2] = 3.0 + rng.normal(size=200) * 0.005   # the plane z = 3
    pts[180:] += rng.uniform(0.5, 2.0, size=(20, 3))  # outliers
    return pts


def test_fit_plane_matches_jax(rng):
    pts = plane_points(rng)
    n, d, mask = ar.fit_plane(pts)
    jn, jd, jmask = jar.fit_plane(pts)
    np.testing.assert_array_equal(n, jn)
    assert d == jd
    np.testing.assert_array_equal(mask, jmask)
    assert abs(abs(n @ [0.0, 0.0, 1.0]) - 1.0) < 0.02 and mask.sum() > 150
    assert ar.fit_plane(pts[:9]) is None and jar.fit_plane(pts[:9]) is None


@pytest.mark.parametrize("normal", [(0.0, 0.0, -1.0), (1.0, 0.0, 0.0),
                                    (0.3, -0.2, 0.9)])
def test_cube_matches_jax(normal):
    center, n = np.array([0.05, -0.02, 2.0]), np.array(normal)
    np.testing.assert_array_equal(ar.cube_vertices(center, n, 0.3),
                                  jar.cube_vertices(center, n, 0.3))
    img = np.full((240, 320), 50.0, np.float32)
    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
    Tcw = np.eye(4)
    out = ar.draw_cube(img, Tcw, K, center, n, 0.3)
    np.testing.assert_array_equal(out, jar.draw_cube(img, Tcw, K, center, n,
                                                     0.3))
    assert out.dtype == np.uint8 and (out == 255).sum() > 100


@pytest.mark.parametrize("case", ["map", "vo", "init"])
def test_annotate_frame_matches_jax(rng, case):
    img = rng.uniform(0, 255, size=(120, 160)).astype(np.float32)
    xy = rng.uniform(10, 100, size=(20, 2)).astype(np.float32)
    mask = np.ones(20, bool)
    mask[3] = False
    kw = {}
    if case == "vo":
        vo = np.zeros(20, bool)
        vo[:8] = True
        kw = dict(vo_mask=vo)
    elif case == "init":
        ref_xy = xy + rng.uniform(-15, 15, size=xy.shape).astype(np.float32)
        kw = dict(init_vis=(ref_xy, xy))
    out = viewer.annotate_frame(img, xy, mask, **kw)
    np.testing.assert_array_equal(out, jviewer.annotate_frame(img, xy, mask,
                                                              **kw))
    assert out.dtype == np.uint8 and out.shape == (120, 160, 3)
    colored = (~np.all(out == out[..., :1], axis=2)).sum()
    assert colored > (100 if case == "init" else 19 * 4)


@pytest.mark.parametrize("args", [
    (5, 100, 42, 0, False), (5, 100, 42, 7, True), (0, 0, 0, 3, False)])
def test_status_text_matches_jax(args):
    for st in ("OK", "LOST", "NOT_INITIALIZED"):
        assert (viewer.status_text(TrackingState[st], *args)
                == jviewer.status_text(JTrackingState[st], *args))


def _arena(mod, rng_seed):
    rng = np.random.default_rng(rng_seed)
    a = mod.MapArena()
    feats = mod.FrameFeatures(
        xy=np.zeros((4, 2), np.float32), xy_und=np.zeros((4, 2), np.float32),
        response=np.zeros(4, np.float32), angle=np.zeros(4, np.float32),
        octave=np.zeros(4, np.int32), desc=np.zeros((4, 8), np.uint32),
        valid=np.ones(4, bool))
    kfs = []
    for i in range(3):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(size=3).astype(np.float32)
        kfs.append(a.new_keyframe(i, 0.1 * i, T, feats))
    for i, j, w in ((0, 1, 30), (1, 2, 120)):
        kfs[i].covis[kfs[j].id] = kfs[j].covis[kfs[i].id] = w
    kfs[1].parent, kfs[2].parent = kfs[0].id, kfs[1].id
    for _ in range(5):
        a.new_point(rng.normal(size=3).astype(np.float32),
                    np.zeros(8, np.uint32), 0, 0)
    return a


def test_export_map_ply_matches_jax(tmp_path):
    p, jp = tmp_path / "port.ply", tmp_path / "jax.ply"
    viewer.export_map_ply(str(p), _arena(arena, 3))
    jviewer.export_map_ply(str(jp), _arena(jarena, 3))
    text = p.read_text()
    assert text == jp.read_text()
    assert "element vertex 8" in text and "element edge 4" in text


def test_line_is_bounded_and_matches_jax_inside(rng, monkeypatch):
    H, W = 240, 320
    sizes = []
    linspace = np.linspace

    def counted(a, b, num=50, **kw):
        sizes.append(num)
        return linspace(a, b, num, **kw)
    monkeypatch.setattr(np, "linspace", counted)
    out = np.zeros((H, W, 3), np.uint8)
    viewer._line(out, (-1e9, 100.0), (1e9, 100.0), (1, 2, 3))
    viewer._line(out, (-1e9, -1e9), (1e9, 1e9), (1, 2, 3))
    viewer._line(out, (5.0, -1e9), (5.0, -1e8), (1, 2, 3))   # all outside
    img = np.zeros((H, W), np.uint8)
    ar._draw_line(img, (-1e9, 50.0), (1e9, 60.0))
    monkeypatch.setattr(np, "linspace", linspace)
    assert sizes and max(sizes) <= max(W, H) + 1
    assert (out[100] == (1, 2, 3)).all()                    # the whole row
    assert (out[np.arange(H), np.arange(H)] == (1, 2, 3)).all()
    assert (out[:, 5] == 0).sum() > 0 and img[50:61].sum() > 0
    # Inside the image: the JAX pixels, for float32 keypoints and float64
    # projections, on and off the borders.
    ends = [rng.uniform([0, 0], [W - 1, H - 1], size=(2, 2)) for _ in range(60)]
    ends += [np.array([[0.0, 0.0], [W - 1.0, H - 1.0]]),
             np.array([[0.0, H - 1.0], [W - 1.0, 0.0]]),
             np.array([[3.5, 7.5], [3.5, 7.5]])]
    for k, (p0, p1) in enumerate(ends):
        if k % 2:
            p0, p1 = p0.astype(np.float32), p1.astype(np.float32)
        a, b = np.zeros((H, W, 3), np.uint8), np.zeros((H, W, 3), np.uint8)
        viewer._line(a, p0, p1, (9, 8, 7))
        jviewer._line(b, p0, p1, (9, 8, 7))
        np.testing.assert_array_equal(a, b)
        a, b = np.zeros((H, W), np.uint8), np.zeros((H, W), np.uint8)
        ar._draw_line(a, p0, p1)
        jar._draw_line(b, p0, p1)
        np.testing.assert_array_equal(a, b)


def test_live_viewer_serves_and_toggles():
    from orb_slam_system_tpu_torch.drivers.mono_synthetic import (
        make_config, render_sequence)
    from orb_slam_system_tpu_torch.models.system import System

    cfg = make_config(n_features=400)
    frames, poses = render_sequence(cfg, 14)
    slam = System(cfg, device="cpu", use_viewer=True, viewer_port=0)
    assert isinstance(slam.viewer, viewer.LiveViewer)
    base = f"http://127.0.0.1:{slam.viewer.port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return resp.read()

    def post(action):
        req = urllib.request.Request(base + f"/cmd?action={action}",
                                     method="POST")
        urllib.request.urlopen(req, timeout=10).read()

    try:
        for i, img in enumerate(frames):
            if i == len(frames) // 2:
                get("/frame.png")   # arms the frame gate
            slam.track_monocular(img, i / 30.0)
        assert slam.get_tracking_state() == TrackingState.OK
        html = get("/")
        assert b"canvas" in html and b"localization" in html
        png = get("/frame.png")
        for retry in range(5):      # a slow frame can outlast the gate
            if len(png) > 1000:
                break
            slam.track_monocular(frames[-1], (len(frames) + retry) / 30.0)
            png = get("/frame.png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 1000
        status = json.loads(get("/status"))
        assert "OK" in status["line"] and status["localization"] is False
        m = json.loads(get("/map.json"))
        assert len(m["pts"]) > 100 and len(m["kfs"]) >= 2 and m["cur"]
        assert len(m["frusta"]) == len(m["kfs"])
        assert all(len(fr) == 5 and len(fr[0]) == 3 for fr in m["frusta"])
        assert m["cur_frustum"] and len(m["cur_frustum"]) == 5
        assert all(e[2] in ("c", "t", "l") for e in m["edges"])
        assert any(e[2] == "t" for e in m["edges"])
        assert get("/map.ply").startswith(b"ply")
        # The pipelined mode updates the viewer once per frame too.
        n0 = slam.viewer.n
        more = ((img, (len(frames) + k) / 30.0)
                for k, img in enumerate(frames[-3:]))
        assert len(list(slam.track_monocular_pipelined(more))) == 3
        assert slam.viewer.n == n0 + 3

        post("toggle_localization")
        assert slam.tracker.only_tracking is True
        assert json.loads(get("/status"))["localization"] is True
        post("toggle_localization")
        assert slam.tracker.only_tracking is False

        post("insert_cube")
        assert len(slam.viewer.cubes) == 1
        m = json.loads(get("/map.json"))
        assert len(m["cubes"]) == 1 and len(m["cubes"][0]) == 8
        get("/frame.png")
        slam.track_monocular(frames[-1], (len(frames) + 9) / 30.0)
        assert get("/frame.png")[:8] == b"\x89PNG\r\n\x1a\n"
        post("clear_cubes")
        assert len(slam.viewer.cubes) == 0

        post("reset")
        assert slam.arena.n_keyframes() == 0
    finally:
        slam.shutdown()
