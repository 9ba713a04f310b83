"""The port stands alone (no jax, no JAX package) and its kernel wrappers
dispatch on the tensor's device: a CPU tensor takes the plain version and
touches nothing CUDA-only."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import orb_slam_system_tpu_torch as pkg
import chip_smoke, kernel_times
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for new in ("vocab.vocabulary", "mapping.keyframe_db",
            "models.place_recognition", "solvers.pnp", "solvers.sim3",
            "solvers.pose_graph", "models.loop_closing",
            "drivers.loop_synthetic", "ops.stereo", "drivers.stereo_synthetic",
            "drivers.rgbd_synthetic", "native", "dataio.datasets",
            "dataio.layouts", "models.viewer", "mapping.serialize",
            "drivers._driver_util", "drivers.mono_tum", "drivers.rgbd_tum",
            "drivers.mono_kitti", "drivers.stereo_kitti", "drivers.mono_euroc",
            "drivers.stereo_euroc", "drivers.evaluate_ate",
            "drivers.run_dataset", "parallel", "parallel.multi_system",
            "parallel.multiseq", "drivers.multiseq_throughput",
            "drivers.endurance_synthetic", "drivers.kitti_synthetic",
            "models.ar", "dataio.ros_bridge", "dataio.ros_replay",
            "drivers.ros_mono", "drivers.ros_stereo", "drivers.ros_rgbd",
            "drivers.ros_mono_ar", "drivers.live_camera",
            "drivers.video_slam", "drivers.warm_cache", "utils.warmup",
            "utils.collectives", "parallel.ba_dist",
            "parallel.pose_graph_dist", "parallel.launch"):
    assert pkg.__name__ + "." + new in names, new
for n in names:
    importlib.import_module(n)
import inspect
from orb_slam_system_tpu_torch.models.system import System
for m in ("track_monocular_stream", "track_monocular_pipelined",
          "track_stereo_pipelined", "track_rgbd_pipelined",
          "track_monocular_prebuilt", "save_map", "load_map"):
    assert callable(getattr(System, m)), m
from orb_slam_system_tpu_torch import native
assert native._lib is None, "the native decoder was built at import"
assert "async_mapping" in inspect.signature(System).parameters
assert "use_viewer" in inspect.signature(System).parameters
assert "prewarm" in inspect.signature(System).parameters
from orb_slam_system_tpu_torch.parallel import multiseq
for name in ("make_mesh", "make_multiseq_step", "dryrun", "dryrun_multichip"):
    assert callable(getattr(multiseq, name)), name
from orb_slam_system_tpu_torch.models import viewer
for name in ("annotate_frame", "status_text", "export_map_ply", "LiveViewer",
             "StatsViewer", "write_pgm", "encode_png"):
    assert hasattr(viewer, name), name
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "orb_slam_system_tpu" or m.startswith("orb_slam_system_tpu.")
             or m.split(".")[0] in ("tools", "examples"))
assert not bad, bad
assert "triton" not in sys.modules
print(len(names))
"""

_CPU_DISPATCH = """
import sys
import numpy as np, torch
from orb_slam_system_tpu_torch.ops import brief, fast, patches
from orb_slam_system_tpu_torch.utils import kernels
rng = np.random.default_rng(0)
img = torch.from_numpy(rng.integers(0, 256, (1, 64, 80)).astype(np.float32))
assert torch.equal(fast.fast_score_nms(img, 19),
                   fast.nms3x3(fast.fast_score_map(img, 19)))
xy = torch.from_numpy(rng.integers(21, 43, (1, 16, 2)).astype(np.int32))
b1, m1 = patches.gather_blur_moments(img, xy, 21)
b2, m2 = patches.gather_blur_moments_plain(img, xy, 21)
assert torch.equal(b1, b2) and torch.equal(m1, m2)
assert torch.equal(patches.gather_patches(img, xy, 21),
                   patches.gather_patches_plain(img, xy, 21))
m3, a3, d3 = patches.gather_blur_describe(img, xy, 21)
m4, a4, d4 = patches.gather_blur_describe_plain(img, xy, 21)
assert torch.equal(m3, m4) and torch.equal(a3, a4) and torch.equal(d3, d4)
ang = torch.from_numpy(rng.uniform(0, 6.28, (1, 16)).astype(np.float32))
assert torch.equal(brief.brief_pack(b1, ang), brief.brief_pack_plain(b1, ang))
assert kernels._lib is None, "the kernel library was loaded"
assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
assert "triton" not in sys.modules
print("ok")
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_port_never_imports_jax():
    """Every module of the port (walked, so new ones are covered; the
    place-recognition, relocalization, loop-closing and dataset modules
    named), chip_smoke.py and kernel_times.py import without jax, the JAX
    package, tools/ or examples/, and without building the native decoder;
    the System has its realtime and map entry points. The multi-sequence
    modules (parallel/, drivers/multiseq_throughput) are among them, and
    the long-run drivers, the whole viewer and the AR overlay, the ROS
    bridge and its four nodes, the live and video drivers, the warm pass
    and the sharded solvers."""
    assert int(_run(_IMPORT_ALL).split()[-1]) >= 86


def test_entry_points_default_to_the_card():
    """The CPU runs only when the caller asks for it."""
    import inspect

    from orb_slam_system_tpu_torch.models.frame import FrameBuilder
    from orb_slam_system_tpu_torch.models.local_mapping import LocalMapper
    from orb_slam_system_tpu_torch.models.loop_closing import LoopCloser
    from orb_slam_system_tpu_torch.models.place_recognition import (
        PlaceRecognition)
    from orb_slam_system_tpu_torch.models.system import System
    from orb_slam_system_tpu_torch.models.track_device import TrackPrograms
    from orb_slam_system_tpu_torch.models.tracking import Tracker
    from orb_slam_system_tpu_torch.drivers import (endurance_synthetic,
                                                   kitti_synthetic,
                                                   loop_synthetic,
                                                   mono_synthetic,
                                                   multiseq_throughput)
    from orb_slam_system_tpu_torch.parallel.multi_system import MultiSystem
    from orb_slam_system_tpu_torch.parallel.multiseq import make_multiseq_step
    for entry in (FrameBuilder, TrackPrograms, System, Tracker, LocalMapper,
                  PlaceRecognition, LoopCloser, mono_synthetic.run,
                  loop_synthetic.run, MultiSystem, make_multiseq_step,
                  multiseq_throughput.run_full,
                  multiseq_throughput.run_frontend, endurance_synthetic.run,
                  kitti_synthetic.run):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry
    from orb_slam_system_tpu_torch.drivers import _driver_util, run_dataset
    assert run_dataset.parse_args(["seq"]).device == "cuda"
    assert _driver_util.parse_args("", ["path_to_vocabulary"],
                                   ["none"]).device == "cuda"
    # multiseq_throughput.main parses --device with the dataset drivers'
    # helper; without it the entry point gets "cuda".
    for mod, attr, argv in ((multiseq_throughput, "run_full", ["2", "3", "out"]),
                            (endurance_synthetic, "run", ["10"]),
                            (kitti_synthetic, "run", ["10"])):
        seen = {}
        orig = getattr(mod, attr)
        setattr(mod, attr, lambda *a, **kw: seen.update(kw))
        try:
            mod.main(argv)
        finally:
            setattr(mod, attr, orig)
        assert seen["device"] == "cuda", mod


def test_nodes_and_live_drivers_default_to_the_card(tmp_path, monkeypatch):
    """The ROS nodes, the live and video drivers and the warm pass hand
    "cuda" to the System unless --device says otherwise."""
    import inspect

    from orb_slam_system_tpu_torch.config import save_settings_yaml
    from orb_slam_system_tpu_torch.dataio.ros_replay import (ImageMsg,
                                                             ReplayRospy)
    from orb_slam_system_tpu_torch.drivers import (live_camera,
                                                   mono_synthetic, ros_mono,
                                                   ros_mono_ar, ros_rgbd,
                                                   ros_stereo, video_slam,
                                                   warm_cache)
    from orb_slam_system_tpu_torch.utils import warmup
    settings = str(tmp_path / "s.yaml")
    save_settings_yaml(mono_synthetic.make_config(), settings)
    seen = []

    class Made(Exception):
        pass

    def system(*a, **kw):
        seen.append(kw["device"])
        raise Made
    monkeypatch.setattr(live_camera, "open_capture", lambda index: object())
    for mod, argv in ((ros_mono, [settings]), (ros_stereo, [settings, "false"]),
                      (ros_rgbd, [settings]), (ros_mono_ar, [settings]),
                      (live_camera, [settings]),
                      (video_slam, [settings, str(tmp_path)])):
        monkeypatch.setattr(mod, "System", system)
        kw = ({"rospy_module": ReplayRospy([]), "image_cls": ImageMsg}
              if mod.__name__.split(".")[-1].startswith("ros_") else {})
        for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
            try:
                mod.main(["none", *argv, *extra], **kw)
            except Made:
                pass
            assert seen.pop() == want, mod
    assert inspect.signature(warmup.warm).parameters["device"].default == "cuda"
    monkeypatch.setattr(warm_cache, "warm",
                        lambda cfg, n, verbose, device: seen.append(device))
    warm_cache.main([])
    assert seen == ["cuda"]


def test_wrappers_take_plain_path_on_cpu():
    assert _run(_CPU_DISPATCH).split()[-1] == "ok"
