"""The port's dataset entry points on synthetic sequences written in each
dataset's layout (PNG frames through the native decoder), on the CPU.

  * run_dataset in process on a 320x240 TUM-mono folder of 16 frames (400
    features, a k=10, L=2 ORBvoc-format vocabulary made from a seed): it
    detects the layout, pre-validates the vocabulary, runs drivers/mono_tum,
    writes KeyFrameTrajectory.txt and passes a 10 cm ATE gate (the JAX
    package's tests/test_run_dataset.py::test_run_dataset_end_to_end, which
    is `slow` there);
  * every other driver's main on a few frames of its own layout: it reads
    them all and builds each (one frame build per frame, counted), and
    writes its trajectory file;
  * the vocabulary writer writes tools/make_full_vocab.py's bytes.
The native decoder needs g++ and zlib; these tests skip without them.
"""

import ctypes.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig,  # noqa: E402
                                              Sensor, SlamConfig,
                                              save_settings_yaml)
from orb_slam_system_tpu_torch.dataio import layouts  # noqa: E402
from orb_slam_system_tpu_torch.dataio.synthetic import (  # noqa: E402
    PlanarSceneRenderer, make_texture, orbit_trajectory)
from orb_slam_system_tpu_torch.drivers import (mono_euroc, mono_kitti,  # noqa: E402
                                               rgbd_tum, run_dataset,
                                               stereo_euroc, stereo_kitti)
from orb_slam_system_tpu_torch.models import frame as frame_mod  # noqa: E402
from orb_slam_system_tpu_torch.vocab.vocabulary import generate_orbvoc  # noqa: E402
from tools.make_full_vocab import generate as jgenerate  # noqa: E402

W, H, N_FEATURES = 320, 240, 400
BASELINE = 0.08


@pytest.fixture(scope="module", autouse=True)
def have_native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native decoder cannot build")
    if ctypes.util.find_library("z") is None:
        pytest.skip("zlib is not installed: the native decoder cannot link")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these runs (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(sensor, **kw):
    cam = CameraConfig(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H, bf=260.0 * BASELINE)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=N_FEATURES),
                      sensor=sensor, **kw)


def _scene(n):
    cam = _cfg(Sensor.MONOCULAR).camera
    r = PlanarSceneRenderer(cam.K, W, H,
                            texture=make_texture(size=2048, block=8, seed=7),
                            tex_scale=220.0)
    return r, orbit_trajectory(n, radius=0.35, depth=-2.0, tilt=0.3)


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def test_vocabulary_writer_equals_tool(tmp_path):
    generate_orbvoc(str(tmp_path / "a.txt"), k=10, L=2, seed=0)
    jgenerate(str(tmp_path / "b.txt"), k=10, L=2, seed=0, verbose=False)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()


def test_run_dataset_tum_mono(tmp_path, capsys):
    r, poses = _scene(16)
    seq = tmp_path / "seq"
    layouts.write_tum(str(seq), [_u8(r.render(T)) for T in poses],
                      [i / 30.0 for i in range(16)], poses)
    voc = str(tmp_path / "voc.txt")
    generate_orbvoc(voc, k=10, L=2, seed=0)
    settings = str(tmp_path / "cam.yaml")
    save_settings_yaml(_cfg(Sensor.MONOCULAR), settings)
    rc = run_dataset.main([str(seq), "--voc", voc, "--settings", settings,
                           "--max-ate", "0.10", "--out-dir", str(tmp_path),
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    assert "dataset kind: tum_mono" in out
    assert "ok: k=10 L=2" in out
    assert "Images in the sequence: 16" in out
    assert "median tracking time" in out
    assert "absolute_translational_error.rmse" in out and "gate PASS" in out
    rows = (tmp_path / "KeyFrameTrajectory.txt").read_text().split("\n")
    assert len([r for r in rows if r]) >= 3


def _stereo_yaml(cfg, path):
    """cfg's settings plus identity LEFT/RIGHT rectification blocks (no
    distortion, R = I, P = [K | 0] and [K | -bf])."""
    save_settings_yaml(cfg, path)
    K = cfg.camera.K.astype(np.float64)

    def mat(name, m):
        data = ", ".join(repr(float(v)) for v in m.reshape(-1))
        return (f"{name}: !!opencv-matrix\n   rows: {m.shape[0]}\n   cols: "
                f"{m.shape[1]}\n   dt: d\n   data: [{data}]\n")
    blocks = ""
    for side, tx in (("LEFT", 0.0), ("RIGHT", -cfg.camera.bf)):
        P = np.hstack([K, [[tx], [0.0], [0.0]]])
        blocks += (f"{side}.height: {H}\n{side}.width: {W}\n"
                   + mat(f"{side}.D", np.zeros((1, 5))) + mat(f"{side}.K", K)
                   + mat(f"{side}.R", np.eye(3)) + mat(f"{side}.P", P))
    with open(path, "a") as f:
        f.write(blocks)


def _layout(name, tmp_path, n):
    """(driver module, argv, trajectory file) of a sequence of n frames."""
    r, poses = _scene(n)
    times = [i / 30.0 for i in range(n)]
    frames = [_u8(r.render(T)) for T in poses]
    seq = str(tmp_path / "seq")
    settings = str(tmp_path / "cam.yaml")
    if name == "rgbd_tum":
        cfg = _cfg(Sensor.RGBD, th_depth=40.0, depth_map_factor=5000.0)
        save_settings_yaml(cfg, settings)
        depths = [np.round(r.render_depth(T) * 5000.0).astype(np.uint16)
                  for T in poses]
        layouts.write_tum(seq, frames, times, poses, depths)
        return rgbd_tum, [seq, os.path.join(seq, "associations.txt")], \
            "CameraTrajectory.txt"
    if name in ("mono_kitti", "stereo_kitti"):
        stereo = name == "stereo_kitti"
        cfg = _cfg(Sensor.STEREO if stereo else Sensor.MONOCULAR,
                   th_depth=35.0)
        save_settings_yaml(cfg, settings)
        rights = ([_u8(r.render_stereo(T, BASELINE)[1]) for T in poses]
                  if stereo else None)
        layouts.write_kitti(seq, frames, times, poses, rights)
        return (stereo_kitti if stereo else mono_kitti), [seq], \
            ("CameraTrajectory.txt" if stereo else "KeyFrameTrajectory.txt")
    ns = [1403636579763555584 + 33_333_333 * i for i in range(n)]
    stereo = name == "stereo_euroc"
    rights = ([_u8(r.render_stereo(T, BASELINE)[1]) for T in poses]
              if stereo else None)
    ts = layouts.write_euroc(seq, frames, ns, poses, rights)
    cam0 = os.path.join(seq, "mav0", "cam0")
    if not stereo:
        save_settings_yaml(_cfg(Sensor.MONOCULAR), settings)
        return mono_euroc, [cam0, ts], "KeyFrameTrajectory.txt"
    _stereo_yaml(_cfg(Sensor.STEREO, th_depth=35.0), settings)
    return stereo_euroc, [cam0, os.path.join(seq, "mav0", "cam1"), ts], \
        "CameraTrajectory.txt"


@pytest.mark.parametrize("name,n", [("rgbd_tum", 4), ("stereo_kitti", 4),
                                    ("mono_kitti", 3), ("mono_euroc", 3),
                                    ("stereo_euroc", 3)])
def test_driver_reads_and_builds(name, n, tmp_path, capsys, monkeypatch):
    """Each driver's main reads every frame of its layout and builds each
    once (stereo and RGB-D initialize at frame 0), then writes its
    trajectory file."""
    module, paths, traj = _layout(name, tmp_path, n)
    builds = []
    orig = frame_mod.FrameBuilder._frame

    def counted(builder, packed, timestamp):
        builds.append(timestamp)
        return orig(builder, packed, timestamp)
    monkeypatch.setattr(frame_mod.FrameBuilder, "_frame", counted)
    out_dir = str(tmp_path / "out")
    rc = module.main(["none", str(tmp_path / "cam.yaml"), *paths,
                      "--no-realtime", "--device", "cpu",
                      "--out-dir", out_dir])
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    assert f"Images in the sequence: {n}" in out
    assert "median tracking time" in out
    assert len(builds) == n
    assert os.path.exists(os.path.join(out_dir, traj))
    if name in ("rgbd_tum", "stereo_kitti", "stereo_euroc"):
        rows = open(os.path.join(out_dir, traj)).read().split("\n")
        assert len([r for r in rows if r]) == n   # tracked from frame 0
