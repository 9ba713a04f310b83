"""Monocular EuRoC driver (reference Examples/Monocular/mono_euroc.cc; the
JAX package's examples/mono_euroc.py).

    python -m orb_slam_system_tpu_torch.drivers.mono_euroc \\
        path_to_vocabulary path_to_settings path_to_cam0_dir \\
        path_to_timestamp_file [--no-realtime] [--device cuda|cpu] \\
        [--out-dir DIR]

path_to_cam0_dir is the camera's folder, `<sequence>/mav0/cam0`: frames are
read from its `data/<ns>.png`, in the order of the timestamp file (one ns
value per line). Prints the tracking-time report and writes
KeyFrameTrajectory.txt.
"""

from __future__ import annotations

import sys

from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.dataio.datasets import load_euroc
from orb_slam_system_tpu_torch.drivers._driver_util import (
    make_fetcher, out_path, parse_args, print_timing_report, track_sequence)
from orb_slam_system_tpu_torch.models.system import System


def main(argv=None) -> int:
    args = parse_args(__doc__, ["path_to_vocabulary", "path_to_settings",
                                "path_to_cam0_dir", "path_to_timestamp_file"],
                      argv)
    paths, times = load_euroc(args.path_to_cam0_dir,
                              args.path_to_timestamp_file)
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
