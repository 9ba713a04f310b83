"""RGB-D ROS node (reference Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc; the
JAX package's examples/ros_rgbd.py).

    python -m orb_slam_system_tpu_torch.drivers.ros_rgbd \\
        path_to_vocabulary path_to_settings [--device cuda|cpu]

Node "RGBD": pairs /camera/rgb/image_raw and
/camera/depth_registered/image_raw by approximate time, tracks each pair
with the local mapper on its worker thread, and saves
KeyFrameTrajectory.txt and CameraTrajectory.txt in the working directory on
shutdown. rospy is injectable, as in drivers/ros_mono.py.
"""

from __future__ import annotations

import sys

from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.dataio.ros_bridge import (
    RosRGBDBridge, _import_rospy, attach_rospy_pair)
from orb_slam_system_tpu_torch.drivers._driver_util import parse_command
from orb_slam_system_tpu_torch.models.system import System


def main(argv=None, rospy_module=None, image_cls=None) -> int:
    args = parse_command(__doc__, ["path_to_vocabulary",
                                   "path_to_settings"], argv)
    rospy, image_cls = _import_rospy(rospy_module, image_cls)
    slam = System(args.path_to_settings, Sensor.RGBD, device=args.device,
                  vocabulary_path=args.vocabulary, async_mapping=True)
    attach_rospy_pair(RosRGBDBridge(slam), "/camera/rgb/image_raw",
                      "/camera/depth_registered/image_raw", node_name="RGBD",
                      rospy_module=rospy, image_cls=image_cls)
    rospy.spin()
    slam.shutdown()
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    slam.save_trajectory_tum("CameraTrajectory.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
