"""Monocular KITTI driver (reference Examples/Monocular/mono_kitti.cc; the
JAX package's examples/mono_kitti.py).

    python -m orb_slam_system_tpu_torch.drivers.mono_kitti \\
        path_to_vocabulary path_to_settings path_to_sequence \\
        [--no-realtime] [--device cuda|cpu] [--out-dir DIR]

Reads `times.txt` and `image_0/%06d.png`, prints the tracking-time report
and writes KeyFrameTrajectory.txt (TUM format, stamped with times.txt's
seconds).
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
    paths, times = load_kitti(args.path_to_sequence, stereo=False)
    print(f"Images in the sequence: {len(paths)}")
    slam = System(args.path_to_settings, Sensor.MONOCULAR, device=args.device,
                  vocabulary_path=args.vocabulary)
    with make_fetcher(paths) as images:
        track_times = track_sequence(
            times, lambda i: (images.fetch(i),), slam.track_monocular,
            not args.no_realtime)
    slam.shutdown()
    print_timing_report(track_times)
    slam.save_keyframe_trajectory_tum(out_path(args, "KeyFrameTrajectory.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
