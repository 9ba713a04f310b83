#!/usr/bin/env python3
"""Device and call times of the port's four CUDA kernels in one checkout, on
one NVIDIA GPU.

    python3 kernel_times.py [DIR]

Imports orb_slam_system_tpu_torch from DIR (default: the directory of this
file) and times its kernels through entry points that every checkout of the
port has, so that an older checkout, unpacked with `git archive` into a
git-ignored directory, can be timed against this one in turns on one card:

    mkdir -p build/parent
    git archive <rev> orb_slam_system_tpu_torch | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 kernel_times.py $r; done

The inputs are chip_smoke.py's: frame 0 of its 640x480 orbit, 1000 features
in 1024 slots. Kernel A is timed inside ORBExtractor.detect, as the device
time of all its launches in one frame (their count is printed); kernels B
(its blur mode), C and D, and torch.gather over kernel D's flat indices
(D's library yardstick), through their wrappers. "describe_stage" is every
device kernel between the canvas and the angles and descriptors: kernel
B's describe mode (patches.gather_blur_describe) where the checkout has it,
else the chain gather_blur_moments -> angles_from_moments -> brief_pack;
"kernels" is how many it launches per frame. "device_ms": the kernels' own
device time per frame from torch.profiler; "call_ms": CUDA events around
20 calls (not for A, whose calls sit inside detect). chip_smoke.py holds the kernels against their
plain versions; this script only times them. Prints one JSON line with the
card's name and power limit; exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from chip_smoke import cuda_ms, device_ms, fail, stage_device_ms  # noqa: E402


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    sys.path.insert(0, root)
    import orb_slam_system_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        fail(f"imported {pkg.__file__}, not the checkout at {root}")
    from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig,
                                                  SlamConfig)
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu_torch.models.frame import FrameBuilder
    from orb_slam_system_tpu_torch.ops import brief, patches
    from orb_slam_system_tpu_torch.ops.orientation import angles_from_moments
    from orb_slam_system_tpu_torch.utils import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0].strip() if smi.stdout else "?"
    dev = torch.device("cuda")
    W, H = 640, 480
    cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=1000))
    renderer = PlanarSceneRenderer(cam.K, W, H, texture=make_texture(2048, 8, 7),
                                   tex_scale=440.0)
    T0 = orbit_trajectory(30, radius=0.35, depth=-2.0, tilt=0.3)[0]
    frame = np.clip(renderer.render(T0), 0, 255).astype(np.uint8)
    img = torch.from_numpy(frame).to(dev).to(torch.float32)[None]
    ex = FrameBuilder(cfg, dev).extractor

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _, canvas, xy, _ = ex.detect(img)
    torch.cuda.synchronize()
    launches_a = kernels.LAUNCHES["fast_score_nms"]
    blurred, mom = patches.gather_blur_moments(canvas, xy, 21)
    ang = angles_from_moments(mom)
    Bc, Hc, Wc = canvas.shape
    flat_canvas = canvas.reshape(Bc, Hc * Wc)
    flat = patches.gather_flat_index(xy, 21, Hc, Wc)

    times = {"fast_score_nms": dict(
        launches_per_frame=launches_a,
        device_ms=launches_a * device_ms(torch, lambda: ex.detect(img),
                                         "fast_score_nms_kernel", 20,
                                         launches_a))}
    for name, fn, kernel in (
            ("gather_blur_moments",
             lambda: patches.gather_blur_moments(canvas, xy, 21),
             "gather_blur_moments_kernel"),
            ("brief_pack", lambda: brief.brief_pack(blurred, ang),
             "brief_pack_kernel"),
            ("gather_patches", lambda: patches.gather_patches(canvas, xy, 21),
             "gather_patches_kernel"),
            ("torch.gather", lambda: torch.gather(flat_canvas, 1, flat), None)):
        times[name] = dict(call_ms=cuda_ms(torch, fn),
                           device_ms=device_ms(torch, fn, kernel))
    if hasattr(patches, "gather_blur_describe"):
        stage = lambda: patches.gather_blur_describe(canvas, xy, 21)
    else:
        # Only for checkouts older than the describe mode; remove this
        # branch once the checkouts timed against this one all have it.
        def stage():
            b, m = patches.gather_blur_moments(canvas, xy, 21)
            return brief.brief_pack(b, angles_from_moments(m))
    stage_ms, n_kernels = stage_device_ms(torch, stage)
    times["describe_stage"] = dict(call_ms=cuda_ms(torch, stage),
                                   device_ms=stage_ms, kernels=n_kernels)
    print(json.dumps({"root": root, "card": card, "kernels": times}),
          flush=True)


if __name__ == "__main__":
    main()
