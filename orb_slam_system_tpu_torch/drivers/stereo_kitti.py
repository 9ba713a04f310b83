"""Stereo KITTI driver (reference Examples/Stereo/stereo_kitti.cc:39-125;
the JAX package's examples/stereo_kitti.py).

    python -m orb_slam_system_tpu_torch.drivers.stereo_kitti \\
        path_to_vocabulary path_to_settings path_to_sequence \\
        [--no-realtime] [--device cuda|cpu] [--out-dir DIR]

Reads `times.txt`, `image_0/%06d.png` and `image_1/%06d.png` (rectified
pairs) and writes CameraTrajectory.txt in KITTI format (:125).
"""

from __future__ import annotations

import sys

from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.dataio.datasets import load_kitti
from orb_slam_system_tpu_torch.drivers._driver_util import (
    make_fetcher, out_path, parse_args, print_timing_report, track_sequence)
from orb_slam_system_tpu_torch.models.system import System


def main(argv=None) -> int:
    args = parse_args(__doc__, ["path_to_vocabulary", "path_to_settings",
                                "path_to_sequence"], argv)
    left, right, times = load_kitti(args.path_to_sequence, stereo=True)
    print(f"Images in the sequence: {len(left)}")
    slam = System(args.path_to_settings, Sensor.STEREO, device=args.device,
                  vocabulary_path=args.vocabulary)
    with make_fetcher(left) as lefts, make_fetcher(right) as rights:
        track_times = track_sequence(
            times, lambda i: (lefts.fetch(i), rights.fetch(i)),
            slam.track_stereo, not args.no_realtime)
    slam.shutdown()
    print_timing_report(track_times)
    slam.save_trajectory_kitti(out_path(args, "CameraTrajectory.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
