"""The traffic generator renders a seed's frames the same whenever the run
reaches them, and never hands out a frame it has not rendered."""

import json
import os

import numpy as np
import pytest

import bench_support
from harness import scene


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
