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
            "drivers.loop_synthetic"):
    assert pkg.__name__ + "." + new in names, new
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "orb_slam_system_tpu" or m.startswith("orb_slam_system_tpu."))
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
    place-recognition, relocalization and loop-closing modules named),
    chip_smoke.py and kernel_times.py import without jax or the JAX
    package."""
    assert int(_run(_IMPORT_ALL).split()[-1]) >= 48


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
    from orb_slam_system_tpu_torch.drivers import loop_synthetic, mono_synthetic
    for entry in (FrameBuilder, TrackPrograms, System, Tracker, LocalMapper,
                  PlaceRecognition, LoopCloser, mono_synthetic.run,
                  loop_synthetic.run):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry


def test_wrappers_take_plain_path_on_cpu():
    assert _run(_CPU_DISPATCH).split()[-1] == "ok"
