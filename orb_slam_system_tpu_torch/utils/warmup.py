"""The warm pass before serving (the JAX package's utils/warmup.py).

A System's first frames pay one-time costs that later frames do not: on
the card the nvcc build of the kernel library at first use
(utils/kernels.py), the g++ build of the native loader (native/), the
cuBLAS and cuSOLVER handles of the first solves, the caching allocator's
first pools, and the vocabulary's node tables when a vocabulary is first
used on the device. `warm` pays them up front: it drives a short synthetic
orbit through two throwaway Systems, one sequential with synchronous
mapping and one pipelined with the async mapper (whose backlogged queue
takes mapper paths the synchronous one never does).

It runs at the camera and ORB settings of the config it is given (the JAX
pass hard-codes 640x480); without one, at 640x480 and 1000 features.
Opt-in at construction, `System(..., prewarm=True)` (PREWARM_FRAMES frames
a mode), or once per process with
`python -m orb_slam_system_tpu_torch.drivers.warm_cache`.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                              SlamConfig)
from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)

MODES = (("sequential+sync", False, False), ("pipelined+async", True, True))

PREWARM_FRAMES = 72   # frames a mode of System(prewarm=True)'s pass

_WARMING = False


def default_config() -> SlamConfig:
    """The JAX pass's camera: 640x480, fx = fy = 520, 1000 features."""
    W, H = 640, 480
    cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=1000),
                      sensor=Sensor.MONOCULAR)


def built_libraries() -> List[Path]:
    """The shared libraries built so far under the repository's build/:
    the CUDA kernel library (one per source hash) and the native loader."""
    from orb_slam_system_tpu_torch import native
    from orb_slam_system_tpu_torch.utils import kernels
    return sorted(list(kernels.BUILD_ROOT.glob("*/liborb_kernels.so"))
                  + list(native.BUILD_ROOT.glob("*/libslamdata.so")))


def warm(cfg: Optional[SlamConfig] = None, n_frames: int = 72,
         verbose: bool = True, device="cuda") -> dict:
    """Drive `n_frames` of a synthetic orbit at cfg's camera and ORB
    settings (monocular) through each of MODES on `device`. Returns
    {mode: seconds}; a call made while a pass runs returns {} at once."""
    global _WARMING
    if _WARMING:
        return {}
    _WARMING = True
    try:
        from orb_slam_system_tpu_torch import native
        from orb_slam_system_tpu_torch.models.system import System

        cfg = dataclasses.replace(cfg or default_config(),
                                  sensor=Sensor.MONOCULAR)
        cam = cfg.camera
        r = PlanarSceneRenderer(cam.K, cam.width, cam.height,
                                texture=make_texture(2048, 8, 7),
                                tex_scale=220.0 * cam.width / 320)
        poses = orbit_trajectory(n_frames, radius=0.35, depth=-2.0, tilt=0.3)
        frames = [np.clip(r.render(T), 0, 255).astype(np.uint8)
                  for T in poses]
        native.library()
        seconds = {}
        for mode, use_async, use_pipe in MODES:
            t0 = time.perf_counter()
            slam = System(cfg, Sensor.MONOCULAR, device=device,
                          async_mapping=use_async)
            try:
                if use_pipe:
                    for _ in slam.track_monocular_pipelined(
                            (f, i / 30.0) for i, f in enumerate(frames)):
                        pass
                else:
                    for i, f in enumerate(frames):
                        slam.track_monocular(f, i / 30.0)
            finally:
                slam.shutdown()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            seconds[mode] = time.perf_counter() - t0
            if verbose:
                print(f"# warmed {mode}: {n_frames} frames at "
                      f"{cam.width}x{cam.height} in {seconds[mode]:.1f} s",
                      flush=True)
        if verbose:
            libs = built_libraries()
            print(f"# built libraries: {len(libs)} "
                  f"{[str(p) for p in libs]}", flush=True)
        return seconds
    finally:
        _WARMING = False
