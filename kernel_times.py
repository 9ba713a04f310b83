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
20 calls (not for A, whose calls sit inside detect). The pose LM is timed on
tracking's shape (1024 slots, 1000 matched, 10% of them outliers): kernel E
("pose_lm", one pose; "pose_lm_n2048", one pose at 2048 slots, 2000
matched; "pose_lm_s5", five through pose_optimization_batch)
where the checkout has it, and the eager `_lm` on the card ("pose_lm_plain",
call ms over 3 calls) in every checkout. chip_smoke.py and
tests/test_torch_cuda.py hold the kernels against their plain versions;
this script only times them. Prints one JSON line with the
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


def pose_problem(rng, S: int, N: int = 1024, n_valid: int = 1000):
    """S pose LMs as tracking poses them, as numpy (T0, Xw, obs,
    inv_sigma2, valid): N slots, the first n_valid matched to points 2-10 m
    ahead with 0.5 px noise, 10% of those 20-80 px off, octaves 0-7, a
    start 2 cm and ~0.6 degrees off the true pose (identity)."""
    fx = fy = 517.306
    cx, cy = 318.643, 255.314
    X = np.stack([rng.uniform(-3, 3, (S, N)), rng.uniform(-2, 2, (S, N)),
                  rng.uniform(2, 10, (S, N))], -1).astype(np.float32)
    uv = np.stack([fx * X[..., 0] / X[..., 2] + cx,
                   fy * X[..., 1] / X[..., 2] + cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    out = rng.uniform(size=(S, N)) < 0.1
    uv[out] += rng.uniform(20, 80, (int(out.sum()), 2))
    inv_s2 = 1.0 / 1.2 ** (2 * rng.integers(0, 8, (S, N)))
    valid = np.zeros((S, N), bool)
    valid[:, :n_valid] = True
    T0 = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    T0[:, :3, 3] = 0.02 / np.sqrt(3)
    c, s = np.cos(0.01), np.sin(0.01)
    T0[:, :2, :2] = [[c, -s], [s, c]]
    return (T0, X, uv.astype(np.float32), inv_s2.astype(np.float32), valid,
            (fx, fy, cx, cy))


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

    from orb_slam_system_tpu_torch.solvers import pose_opt
    for name, S, N in (("pose_lm", 1, 1024), ("pose_lm_n2048", 1, 2048),
                       ("pose_lm_s5", 5, 1024)):
        *arrays, cam = pose_problem(np.random.default_rng(0), S, N,
                                    N * 1000 // 1024)
        T0, X, uv, inv_s2, valid = (torch.from_numpy(a).to(dev)
                                    for a in arrays)
        if S == 1:
            T0, X, uv, inv_s2, valid = (a[0] for a in (T0, X, uv, inv_s2,
                                                       valid))
            lm = lambda: pose_opt.pose_optimization(T0, X, uv, inv_s2, valid,
                                                    *cam)
            if N == 1024:
                plain = lambda: pose_opt._lm(T0, X, uv, inv_s2, valid, *cam,
                                             None, 0.0, 4, 10, None)
                times["pose_lm_plain"] = dict(call_ms=cuda_ms(torch, plain,
                                                              3))
        else:
            lm = lambda: pose_opt.pose_optimization_batch(T0, X, uv, inv_s2,
                                                          valid, *cam)
        if hasattr(pose_opt, "pose_lm"):
            times[name] = dict(call_ms=cuda_ms(torch, lm),
                               device_ms=device_ms(torch, lm,
                                                   "pose_lm_kernel"))
    print(json.dumps({"root": root, "card": card, "kernels": times}),
          flush=True)


if __name__ == "__main__":
    main()
