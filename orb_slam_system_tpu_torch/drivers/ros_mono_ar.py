"""Monocular AR ROS node (reference Examples/ROS/ORB_SLAM2/src/AR/
ros_mono_ar.cc + ViewerAR.cc; the JAX package's examples/ros_mono_ar.py).

    python -m orb_slam_system_tpu_torch.drivers.ros_mono_ar \\
        path_to_vocabulary path_to_settings [--out_dir DIR] \\
        [--device cuda|cpu]

Node "MonoAR": tracks /camera/image_raw with the local mapper on its worker
thread, fits a dominant plane to the map and draws the anchored virtual
cube into each frame (models/ar.ARDemo). With --out_dir every overlay is
written there as ar_NNNNNN.pgm (the reference shows them in a Pangolin
window; this node is headless). rospy is injectable, as in
drivers/ros_mono.py.
"""

from __future__ import annotations

import os
import sys

from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.dataio.ros_bridge import (_import_rospy,
                                                         decode_image_msg)
from orb_slam_system_tpu_torch.drivers._driver_util import parse_command
from orb_slam_system_tpu_torch.models.ar import ARDemo
from orb_slam_system_tpu_torch.models.system import System
from orb_slam_system_tpu_torch.models.viewer import write_pgm


def main(argv=None, rospy_module=None, image_cls=None) -> int:
    args = parse_command(
        __doc__, ["path_to_vocabulary", "path_to_settings"], argv,
        lambda ap: ap.add_argument("--out_dir", default=None))
    rospy, image_cls = _import_rospy(rospy_module, image_cls)
    slam = System(args.path_to_settings, Sensor.MONOCULAR, device=args.device,
                  vocabulary_path=args.vocabulary, async_mapping=True)
    demo = ARDemo(slam)
    n_saved = 0

    def cb(msg):
        nonlocal n_saved
        overlay = demo.process(decode_image_msg(msg),
                               msg.header.stamp.to_sec())
        if args.out_dir is not None:
            os.makedirs(args.out_dir, exist_ok=True)
            write_pgm(os.path.join(args.out_dir, f"ar_{n_saved:06d}.pgm"),
                      overlay)
            n_saved += 1

    rospy.init_node("MonoAR", anonymous=True)
    rospy.Subscriber("/camera/image_raw", image_cls, cb, queue_size=1)
    rospy.spin()
    slam.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
