"""Live-camera monocular driver (the reference's `myslam`; the JAX
package's examples/live_camera.py).

    python -m orb_slam_system_tpu_torch.drivers.live_camera \\
        path_to_vocabulary path_to_settings [camera_index] \\
        [--max-frames N] [--classic] [--device cuda|cpu] [--out-dir DIR]

Equivalent of Examples/Monocular/laptop_camera.cpp:6-20: open
cv::VideoCapture(index) at 1280x720, stamp frames with wall-clock time,
and feed the System until the capture ends, with the local mapper on its
worker thread. Frames go through track_monocular_pipelined (two frames in
flight on the card) unless --classic; --max-frames bounds the run. Without
a camera (or without cv2) it reports and exits with code 2.
KeyFrameTrajectory.txt is written to --out-dir at the end.

`run` takes any capture object: read() -> (ok, HxW[x3] uint8, BGR) and
release().
"""

from __future__ import annotations

import sys
import time

import numpy as np

from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.drivers._driver_util import (out_path,
                                                            parse_command)
from orb_slam_system_tpu_torch.models.system import System

CAPTURE_W, CAPTURE_H = 1280, 720   # laptop_camera.cpp:8-10


def open_capture(index: int = 0):
    """cv2.VideoCapture at the reference's 1280x720; None without cv2 or
    without a device at `index` (the caller reports and exits 2)."""
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(index)
    if not cap.isOpened():
        cap.release()
        return None
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, CAPTURE_W)
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, CAPTURE_H)
    return cap


def frame_source(cap, max_frames=None):
    """(gray f32[H,W], wall-clock seconds) frames from a capture object.
    Stops on read failure or after max_frames."""
    t_origin = time.time()
    n = 0
    while max_frames is None or n < max_frames:
        ok, img = cap.read()
        if not ok or img is None:
            break
        img = np.asarray(img)
        if img.ndim == 3:
            # BGR (cv2 convention) -> gray, reference Tracking::
            # GrabImageMonocular (src/Tracking.cc:155-160) with RGB=0.
            img = (0.114 * img[..., 0] + 0.587 * img[..., 1]
                   + 0.299 * img[..., 2])
        yield img.astype(np.float32), time.time() - t_origin
        n += 1


def run(slam, cap, max_frames=None, pipelined=True, report_every=30):
    """Track a live capture until it ends; returns frames processed."""
    src = frame_source(cap, max_frames)
    n = 0
    it = (slam.track_monocular_pipelined(src) if pipelined
          else (slam.track_monocular(im, t) for im, t in src))
    for _ in it:
        n += 1
        if report_every and n % report_every == 0:
            print(f"frame {n}: state={slam.get_tracking_state().name} "
                  f"kfs={slam.arena.n_keyframes()}", flush=True)
    return n


def _flags(ap):
    ap.add_argument("camera_index", nargs="?", type=int, default=0)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--classic", action="store_true",
                    help="track frame by frame (no pipelining)")
    ap.add_argument("--out-dir", default=".")


def main(argv=None) -> int:
    args = parse_command(__doc__, ["path_to_vocabulary",
                                   "path_to_settings"], argv, _flags)
    cap = open_capture(args.camera_index)
    if cap is None:
        print(f"error: no camera at index {args.camera_index} (or cv2 "
              "unavailable); use video_slam for file/directory sources",
              file=sys.stderr)
        return 2
    slam = System(args.path_to_settings, Sensor.MONOCULAR, device=args.device,
                  vocabulary_path=args.vocabulary, async_mapping=True)
    try:
        n = run(slam, cap, args.max_frames, not args.classic)
    finally:
        cap.release()
        slam.shutdown()
    slam.save_keyframe_trajectory_tum(out_path(args, "KeyFrameTrajectory.txt"))
    print(f"processed {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
