"""The port's live-camera and video drivers on the CPU
(drivers/live_camera.py, drivers/video_slam.py; the JAX package's
examples/live_camera.py and examples/video_slam.py).

Criteria: tests/test_datasets_drivers.py's fake-capture bars (14 frames
read and tracked pipelined from a capture serving 16 BGR renders, the
System OK with >= 2 keyframes at the end, the capture released); main
exits 2 without a camera; a directory of PNGs beside a .txt file tracks
(the .txt skipped) and writes KeyFrameTrajectory.txt; a PNG that does not
decode raises, naming the file (the JAX driver skips it silently); without
ffmpeg a video path raises.
"""

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.config import (Sensor, TrackingState,
                                              save_settings_yaml)
from orb_slam_system_tpu_torch.drivers import (live_camera, mono_synthetic,
                                               video_slam)
from orb_slam_system_tpu_torch.models.system import System
from orb_slam_system_tpu_torch.models.viewer import encode_png

N_FEATURES = 400


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module, as the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """16 u8 renders of the JAX test's orbit (320x240, fx 260, texture 2048
    / seed 7 at scale 220) and a settings file for 400 features."""
    cfg = mono_synthetic.make_config(n_features=N_FEATURES)
    frames, _ = mono_synthetic.render_sequence(cfg, 16)
    settings = str(tmp_path_factory.mktemp("live") / "settings.yaml")
    save_settings_yaml(cfg, settings)
    return cfg, [np.clip(f, 0, 255).astype(np.uint8) for f in frames], settings


class FakeCapture:
    """A cv2-style capture serving BGR copies of the frames."""

    def __init__(self, frames):
        self.frames = frames
        self.i = 0
        self.released = False

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        g = self.frames[self.i]
        self.i += 1
        return True, np.stack([g, g, g], axis=-1)

    def release(self):
        self.released = True


def test_live_camera_fake_capture(scene):
    cfg, frames, _ = scene
    cap = FakeCapture(frames)
    slam = System(cfg, Sensor.MONOCULAR, device="cpu")
    n = live_camera.run(slam, cap, max_frames=14, report_every=0)
    state = slam.get_tracking_state()
    kfs = slam.arena.n_keyframes()
    slam.shutdown()
    cap.release()
    assert n == 14
    assert cap.i == 14
    assert state == TrackingState.OK
    assert kfs >= 2
    assert cap.released


def test_frame_source_gray_and_stamps(scene):
    """BGR to gray with the reference's weights, stamps from the wall
    clock, increasing."""
    _, frames, _ = scene
    rng = np.random.default_rng(0)
    bgr = [rng.integers(0, 256, (4, 5, 3), dtype=np.uint8) for _ in range(3)]

    class Cap(FakeCapture):
        def read(self):
            if self.i >= len(bgr):
                return False, None
            self.i += 1
            return True, bgr[self.i - 1]
    got = list(live_camera.frame_source(Cap(frames)))
    assert len(got) == 3
    for (img, _), b in zip(got, bgr):
        ref = (0.114 * b[..., 0] + 0.587 * b[..., 1]
               + 0.299 * b[..., 2]).astype(np.float32)
        np.testing.assert_array_equal(img, ref)
    stamps = [t for _, t in got]
    assert stamps == sorted(stamps) and stamps[0] >= 0.0


def test_live_camera_main_exits_2_without_a_camera(scene, tmp_path):
    _, _, settings = scene
    assert live_camera.main(["none", settings, "99", "--device", "cpu",
                             "--out-dir", str(tmp_path)]) == 2
    assert not (tmp_path / "KeyFrameTrajectory.txt").exists()


def test_video_slam_png_directory(scene, tmp_path):
    _, frames, settings = scene
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames[:12]):
        (src / f"{i:04d}.png").write_bytes(encode_png(f))
    (src / "notes.txt").write_text("not a frame\n")
    got = list(video_slam.iter_directory(str(src), 30.0))
    assert len(got) == 12
    np.testing.assert_array_equal(got[3][0], frames[3].astype(np.float32))
    assert got[3][1] == 3 / 30.0
    out = tmp_path / "out"
    assert video_slam.main(["none", settings, str(src), "--device", "cpu",
                            "--out-dir", str(out)]) == 0
    rows = (out / "KeyFrameTrajectory.txt").read_text().strip().splitlines()
    assert len(rows) >= 2
    assert all(len(r.split()) == 8 for r in rows)


def test_video_slam_corrupt_png_raises(scene, tmp_path):
    _, frames, settings = scene
    src = tmp_path / "frames"
    src.mkdir()
    (src / "0000.png").write_bytes(encode_png(frames[0]))
    bad = src / "0001.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot a png at all")
    with pytest.raises(RuntimeError, match="0001.png"):
        video_slam.main(["none", settings, str(src), "--device", "cpu",
                         "--out-dir", str(tmp_path / "out")])


def test_video_without_ffmpeg_raises(monkeypatch):
    monkeypatch.setattr(video_slam.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        next(video_slam.iter_video("clip.mp4", 30.0, 320, 240))
