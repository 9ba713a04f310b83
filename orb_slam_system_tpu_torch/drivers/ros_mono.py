"""Monocular ROS node (reference Examples/ROS/ORB_SLAM2/src/ros_mono.cc:64;
the JAX package's examples/ros_mono.py).

    python -m orb_slam_system_tpu_torch.drivers.ros_mono \\
        path_to_vocabulary path_to_settings [--device cuda|cpu]

Node "Mono": subscribes /camera/image_raw, tracks each frame with the
local mapper on its worker thread, and on shutdown saves
KeyFrameTrajectory.txt in the working directory, the reference main's
lifecycle. A vocabulary path of "none" self-trains the vocabulary from the
map. rospy is injectable (`main(..., rospy_module=, image_cls=)`), so the
node runs without ROS against a stub that replays messages.
"""

from __future__ import annotations

import sys

from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.dataio.ros_bridge import (
    RosMonoBridge, _import_rospy, attach_rospy)
from orb_slam_system_tpu_torch.drivers._driver_util import parse_command
from orb_slam_system_tpu_torch.models.system import System


def main(argv=None, rospy_module=None, image_cls=None) -> int:
    args = parse_command(__doc__, ["path_to_vocabulary",
                                   "path_to_settings"], argv)
    rospy, image_cls = _import_rospy(rospy_module, image_cls)
    slam = System(args.path_to_settings, Sensor.MONOCULAR, device=args.device,
                  vocabulary_path=args.vocabulary, async_mapping=True)
    attach_rospy(RosMonoBridge(slam), "/camera/image_raw", node_name="Mono",
                 rospy_module=rospy, image_cls=image_cls)
    rospy.spin()
    slam.shutdown()
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
