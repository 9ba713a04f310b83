"""The port's ROS bridge and its four nodes on the CPU, against the JAX
package's (orb_slam_system_tpu/dataio/ros_bridge.py, examples/ros_*.py).

Messages replay through dataio/ros_replay.ReplayRospy, the stub of the
rospy surface tests/test_ros_nodes.py builds. Criteria: decode_image_msg
gives the JAX decode's bits for every encoding with a padded step;
ApproxTimeSync emits JAX's pairs on a seeded stream of stamps; ros_mono
over 10 frames of the 320x240 orbit (mono_synthetic's scene at 400
features) asks for the async mapper as the JAX node does and, both mapping
synchronously for the comparison, ends OK, tracks as many frames and ends
with as many keyframes as the JAX node on the same messages, its Sim3 ATE
within 1 cm of the JAX node's (tests/test_torch_system_mono.py's bar);
ros_stereo runs with do_rectify false (stereo_synthetic's pairs, every
pair tracked) and true (settings/euroc_stereo.yaml, its rectified pair
within 1e-4 of JAX's remap_bilinear); ros_rgbd writes both trajectories;
ros_mono_ar writes one overlay per message.
"""

import os

import numpy as np
import pytest
import torch

import orb_slam_system_tpu.models.system as jsystem_mod
from orb_slam_system_tpu.dataio import trajectory as jtraj
from orb_slam_system_tpu.dataio.ros_bridge import (
    ApproxTimeSync as JApproxTimeSync, decode_image_msg as j_decode)
from orb_slam_system_tpu_torch.config import TrackingState, save_settings_yaml
from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
from orb_slam_system_tpu_torch.dataio.ros_bridge import (ApproxTimeSync,
                                                         decode_image_msg)
from orb_slam_system_tpu_torch.dataio.ros_replay import (ENCODINGS, ImageMsg,
                                                         ReplayRospy)
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.drivers import (mono_synthetic, ros_mono,
                                               ros_mono_ar, ros_rgbd,
                                               ros_stereo, rgbd_synthetic,
                                               stereo_synthetic)

N_FRAMES = 10
N_FEATURES = 400
SETTINGS = os.path.join(os.path.dirname(__file__), "..",
                        "orb_slam_system_tpu_torch", "settings")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module, as the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    """10 frames of mono_synthetic's 320x240 orbit at 400 features (at
    tests/test_ros_nodes.py's 300 neither package initializes within 10
    frames, so there would be no trajectory to compare) and its settings
    file."""
    cfg = mono_synthetic.make_config(n_features=N_FEATURES)
    imgs, poses = mono_synthetic.render_sequence(cfg, N_FRAMES)
    settings = str(tmp_path_factory.mktemp("ros") / "settings.yaml")
    save_settings_yaml(cfg, settings)
    return imgs, poses, settings


def _recording(cls, made, asked=None):
    """cls, recording each instance in `made`; with `asked` (a list), the
    async_mapping each caller asked for goes there and the System maps
    synchronously instead (the worker thread's timing moves keyframe
    decisions run to run, so only synchronous runs compare frame for
    frame)."""
    class Recorded(cls):
        def __init__(self, *a, **kw):
            if asked is not None:
                asked.append(kw.get("async_mapping"))
                kw["async_mapping"] = False
            super().__init__(*a, **kw)
            made.append(self)
    return Recorded


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_decode_image_msg_bit_equal_to_jax(encoding):
    rng = np.random.default_rng(len(encoding))
    dtype, ch = ENCODINGS[encoding]
    shape = (6, 9) if ch == 1 else (6, 9, ch)
    arr = (rng.uniform(0, 30, shape) if dtype == np.float32
           else rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True))
    msg = ImageMsg.from_array(arr.astype(dtype), 0.5, encoding, pad=5)
    assert msg.step == 9 * ch * np.dtype(dtype).itemsize + 5
    got, ref = decode_image_msg(msg), j_decode(msg)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == (6, 9)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_approx_time_sync_pairs_as_jax():
    rng = np.random.default_rng(3)
    events = []
    for i in range(200):
        for s in rng.permutation(2):
            if rng.uniform() < 0.85:           # drop some messages
                events.append((int(s), f"{s}:{i}",
                               i / 20.0 + rng.normal(0, 0.02)))
    got, ref = [], []
    ours = ApproxTimeSync(lambda a, b, t: got.append((a, b, t)), slop=0.03)
    theirs = JApproxTimeSync(lambda a, b, t: ref.append((a, b, t)), slop=0.03)
    for s, msg, t in events:
        ours.add(s, msg, t)
        theirs.add(s, msg, t)
    assert len(got) > 50
    assert got == ref


def test_ros_mono_node_against_jax(mono, tmp_path, monkeypatch):
    imgs, poses, settings = mono
    script = [("/camera/image_raw", ImageMsg.mono8(im, i / 30.0))
              for i, im in enumerate(imgs)]
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    ours, theirs, asked = [], [], []
    monkeypatch.setattr(ros_mono, "System",
                        _recording(ros_mono.System, ours, asked))
    monkeypatch.setattr(jsystem_mod, "System",
                        _recording(jsystem_mod.System, theirs, asked))
    from examples import ros_mono as j_ros_mono
    results = []
    for name, main, made, io in (("port", ros_mono.main, ours, traj_io),
                                 ("jax", j_ros_mono.main, theirs, jtraj)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        rospy = ReplayRospy(script)
        argv = ["none", settings] + (["--device", "cpu"] if name == "port"
                                     else [])
        assert main(argv, rospy_module=rospy, image_cls=ImageMsg) == 0
        assert rospy.node_name == "Mono"
        rows = (d / "KeyFrameTrajectory.txt").read_text().split("\n")
        slam = made[-1]
        est = io.frame_poses(slam.arena, slam.tracker.trajectory)
        results.append(dict(
            tracked=sum(1 for *_, lost in est if not lost),
            kfs=slam.arena.n_keyframes(), rows=len([r for r in rows if r]),
            ate=io.ate_rmse(est, gt), state=int(slam.get_tracking_state())))
    port, jax_ = results
    assert asked == [True, True]          # both nodes ask for the worker
    assert port["state"] == int(TrackingState.OK)
    assert port["tracked"] == jax_["tracked"]
    assert port["kfs"] == jax_["kfs"] == port["rows"]
    assert abs(port["ate"] - jax_["ate"]) < 0.01


def _stereo_script(pairs, jitter_rng=None):
    script = []
    for i, (left, right) in enumerate(pairs):
        t = i / 30.0
        t_r = t + (jitter_rng.uniform(-0.004, 0.004) if jitter_rng else 0.0)
        script.append(("/camera/left/image_raw", ImageMsg.mono8(left, t)))
        script.append(("/camera/right/image_raw", ImageMsg.mono8(right, t_r)))
    return script


def test_ros_stereo_node_unrectified(tmp_path, monkeypatch):
    cfg = stereo_synthetic.make_config(n_features=N_FEATURES)
    pairs, _ = stereo_synthetic.render_pairs(cfg, N_FRAMES)
    settings = str(tmp_path / "stereo.yaml")
    save_settings_yaml(cfg, settings)
    made = []
    monkeypatch.setattr(ros_stereo, "System",
                        _recording(ros_stereo.System, made))
    monkeypatch.chdir(tmp_path)
    rospy = ReplayRospy(_stereo_script(pairs, np.random.default_rng(0)))
    assert ros_stereo.main(["none", settings, "false", "--device", "cpu"],
                           rospy_module=rospy, image_cls=ImageMsg) == 0
    assert rospy.node_name == "Stereo"
    slam = made[0]
    assert len(slam.tracker.trajectory) == N_FRAMES   # every pair paired
    assert slam.get_tracking_state() == TrackingState.OK
    rows = (tmp_path / "CameraTrajectory.txt").read_text().split("\n")
    assert len([r for r in rows if r]) == N_FRAMES


def test_ros_stereo_node_rectifies_as_jax(tmp_path, monkeypatch):
    """do_rectify true on the package's copy of euroc_stereo.yaml: the pair
    the System is given equals JAX's build_rectify_map + remap_bilinear of
    the decoded messages."""
    from examples.stereo_euroc import build_rectify_map, remap_bilinear
    from orb_slam_system_tpu.config import Sensor as JSensor
    from orb_slam_system_tpu.config import load_settings as j_load

    settings = os.path.join(SETTINGS, "euroc_stereo.yaml")
    jcfg = j_load(settings, JSensor.STEREO)
    W, H = jcfg.camera.width, jcfg.camera.height
    rng = np.random.default_rng(1)
    pairs = [(rng.uniform(0, 255, (H, W)), rng.uniform(0, 255, (H, W)))
             for _ in range(2)]
    seen = []

    class Spy(ros_stereo.System):
        def track_stereo(self, left, right, t):
            seen.append((left.copy(), right.copy()))
            return super().track_stereo(left, right, t)
    monkeypatch.setattr(ros_stereo, "System", Spy)
    monkeypatch.chdir(tmp_path)
    script = _stereo_script(pairs)
    assert ros_stereo.main(["none", settings, "true", "--device", "cpu"],
                           rospy_module=ReplayRospy(script),
                           image_cls=ImageMsg) == 0
    assert len(seen) == len(pairs)
    maps = [build_rectify_map(b["K"], b["D"], b["R"], b["P"], W, H)
            for b in (jcfg.rect_left, jcfg.rect_right)]
    for (left, right), (_, ml), (_, mr) in zip(seen, script[::2],
                                                script[1::2]):
        for got, msg, m in ((left, ml, maps[0]), (right, mr, maps[1])):
            np.testing.assert_allclose(
                got, remap_bilinear(j_decode(msg), *m), atol=1e-4)
    assert (tmp_path / "CameraTrajectory.txt").exists()


def test_ros_rgbd_node(tmp_path, monkeypatch):
    cfg = rgbd_synthetic.make_config(n_features=N_FEATURES)
    cam = cfg.camera
    r = PlanarSceneRenderer(cam.K, cam.width, cam.height,
                            texture=make_texture(size=2048, block=8, seed=7),
                            tex_scale=220.0)
    poses = orbit_trajectory(N_FRAMES, radius=0.35, depth=-2.0, tilt=0.3)
    settings = str(tmp_path / "rgbd.yaml")
    save_settings_yaml(cfg, settings)
    script = []
    for i, T in enumerate(poses):
        depth = (r.render_depth(T) * cfg.depth_map_factor).astype(np.float32)
        script.append(("/camera/rgb/image_raw", ImageMsg.mono8(r.render(T),
                                                               i / 30.0)))
        script.append(("/camera/depth_registered/image_raw",
                       ImageMsg.from_array(depth, i / 30.0, "32FC1")))
    made = []
    monkeypatch.setattr(ros_rgbd, "System", _recording(ros_rgbd.System, made))
    monkeypatch.chdir(tmp_path)
    rospy = ReplayRospy(script)
    assert ros_rgbd.main(["none", settings, "--device", "cpu"],
                         rospy_module=rospy, image_cls=ImageMsg) == 0
    assert rospy.node_name == "RGBD"
    assert made[0].get_tracking_state() == TrackingState.OK
    for name in ("KeyFrameTrajectory.txt", "CameraTrajectory.txt"):
        assert (tmp_path / name).read_text().strip()


def test_ros_mono_ar_node(mono, tmp_path):
    imgs, _, settings = mono
    out_dir = tmp_path / "ar"
    rospy = ReplayRospy([("/camera/image_raw", ImageMsg.mono8(im, i / 30.0))
                         for i, im in enumerate(imgs)])
    assert ros_mono_ar.main(["none", settings, f"--out_dir={out_dir}",
                             "--device", "cpu"], rospy_module=rospy,
                            image_cls=ImageMsg) == 0
    assert rospy.node_name == "MonoAR"
    saved = sorted(os.listdir(out_dir))
    assert saved == [f"ar_{i:06d}.pgm" for i in range(N_FRAMES)]
