"""RGB-D TUM driver (reference Examples/RGB-D/rgbd_tum.cc:38-137; the JAX
package's examples/rgbd_tum.py).

    python -m orb_slam_system_tpu_torch.drivers.rgbd_tum \\
        path_to_vocabulary path_to_settings path_to_sequence \\
        path_to_association [--no-realtime] [--device cuda|cpu] \\
        [--out-dir DIR]

Depth images are read raw (16-bit values; DepthMapFactor in the settings
scales them to metres). Writes CameraTrajectory.txt and
KeyFrameTrajectory.txt (:136-137).
"""

from __future__ import annotations

import sys

from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.dataio.datasets import load_tum_associations
from orb_slam_system_tpu_torch.drivers._driver_util import (
    make_fetcher, out_path, parse_args, print_timing_report, track_sequence)
from orb_slam_system_tpu_torch.models.system import System


def main(argv=None) -> int:
    args = parse_args(__doc__, ["path_to_vocabulary", "path_to_settings",
                                "path_to_sequence", "path_to_association"],
                      argv)
    rgb, depth, times = load_tum_associations(args.path_to_sequence,
                                              args.path_to_association)
    print(f"Images in the sequence: {len(rgb)}")
    slam = System(args.path_to_settings, Sensor.RGBD, device=args.device,
                  vocabulary_path=args.vocabulary)
    with make_fetcher(rgb) as images, make_fetcher(depth, raw16=True) as depths:
        track_times = track_sequence(
            times, lambda i: (images.fetch(i), depths.fetch(i)),
            slam.track_rgbd, not args.no_realtime)
    slam.shutdown()
    print_timing_report(track_times)
    slam.save_trajectory_tum(out_path(args, "CameraTrajectory.txt"))
    slam.save_keyframe_trajectory_tum(out_path(args, "KeyFrameTrajectory.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
