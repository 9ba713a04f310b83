"""Video / image-directory monocular driver (the reference's `myvideo`,
Examples/Monocular/upload_ri_video.cpp; the JAX package's
examples/video_slam.py).

    python -m orb_slam_system_tpu_torch.drivers.video_slam \\
        path_to_vocabulary path_to_settings video_or_directory [fps] \\
        [--device cuda|cpu] [--out-dir DIR]

A directory is read in filename order, stamped at `fps` (30 by default):
its PNG, PGM and PPM files, the formats the port's native decoder reads
(dataio/datasets.load_image_gray); other files are skipped, and a frame
that fails to decode raises, naming the file. A video file is decoded by
ffmpeg piping rawvideo gray frames at the settings' width and height; without
ffmpeg on PATH it raises. Frames are tracked one by one with synchronous
mapping, and KeyFrameTrajectory.txt is written to --out-dir.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np

from orb_slam_system_tpu_torch.config import Sensor, load_settings
from orb_slam_system_tpu_torch.dataio.datasets import load_image_gray
from orb_slam_system_tpu_torch.drivers._driver_util import (out_path,
                                                            parse_command)
from orb_slam_system_tpu_torch.models.system import System

IMAGE_EXTENSIONS = (".png", ".pgm", ".ppm")


def iter_directory(path, fps):
    """(gray f32[H,W], i / fps) for each image file of `path` by name."""
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith(IMAGE_EXTENSIONS))
    for i, f in enumerate(files):
        yield load_image_gray(os.path.join(path, f)), i / fps


def iter_video(path, fps, width, height):
    """(gray f32[height,width], i / fps) per frame of a video file, decoded
    by ffmpeg; raises when ffmpeg is not on PATH."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not available for video decoding")
    cmd = ["ffmpeg", "-i", path, "-f", "rawvideo", "-pix_fmt", "gray",
           "-s", f"{width}x{height}", "-loglevel", "quiet", "-"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    frame_bytes = width * height
    i = 0
    try:
        while True:
            buf = proc.stdout.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            yield np.frombuffer(buf, np.uint8).reshape(height, width).astype(
                np.float32), i / fps
            i += 1
    finally:
        proc.stdout.close()
        proc.wait()


def _flags(ap):
    ap.add_argument("fps", nargs="?", type=float, default=30.0)
    ap.add_argument("--out-dir", default=".")


def main(argv=None) -> int:
    args = parse_command(__doc__, ["path_to_vocabulary", "path_to_settings",
                                   "video_or_directory"], argv, _flags)
    cfg = load_settings(args.path_to_settings, Sensor.MONOCULAR)
    slam = System(cfg, Sensor.MONOCULAR, device=args.device,
                  vocabulary_path=args.vocabulary)
    src = args.video_or_directory
    frames = (iter_directory(src, args.fps) if os.path.isdir(src)
              else iter_video(src, args.fps, cfg.camera.width,
                              cfg.camera.height))
    n = 0
    try:
        for img, t in frames:
            slam.track_monocular(img, t)
            n += 1
            if n % 30 == 0:
                print(f"frame {n}: state={slam.get_tracking_state().name} "
                      f"kfs={slam.arena.n_keyframes()}", flush=True)
    finally:
        slam.shutdown()
    slam.save_keyframe_trajectory_tum(out_path(args, "KeyFrameTrajectory.txt"))
    print(f"processed {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
