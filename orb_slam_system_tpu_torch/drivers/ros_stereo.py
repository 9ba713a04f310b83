"""Stereo ROS node (reference Examples/ROS/ORB_SLAM2/src/ros_stereo.cc;
the JAX package's examples/ros_stereo.py).

    python -m orb_slam_system_tpu_torch.drivers.ros_stereo \\
        path_to_vocabulary path_to_settings do_rectify [--device cuda|cpu]

Node "Stereo": pairs /camera/left/image_raw and /camera/right/image_raw
by approximate time, rectifies each pair on the host when do_rectify is
"true" (from the settings' LEFT/RIGHT.{K,D,R,P} blocks, reference
:72-108, with drivers/stereo_euroc's maps), tracks it with the local mapper
on its worker thread, and saves CameraTrajectory.txt in the working
directory on shutdown. rospy is injectable, as in drivers/ros_mono.py.
"""

from __future__ import annotations

import sys

from orb_slam_system_tpu_torch.config import Sensor, load_settings
from orb_slam_system_tpu_torch.dataio.ros_bridge import (
    RosStereoBridge, _import_rospy, attach_rospy_pair)
from orb_slam_system_tpu_torch.drivers._driver_util import parse_command
from orb_slam_system_tpu_torch.drivers.stereo_euroc import (build_rectify_map,
                                                            remap_bilinear)
from orb_slam_system_tpu_torch.models.system import System


def make_rectifier(cfg):
    """preprocess(left, right) -> the rectified pair, from cfg's LEFT and
    RIGHT calibration blocks; None when either block is missing."""
    if cfg.rect_left is None or cfg.rect_right is None:
        return None
    W, H = cfg.camera.width, cfg.camera.height
    maps = [build_rectify_map(b["K"], b["D"], b["R"], b["P"], W, H)
            for b in (cfg.rect_left, cfg.rect_right)]

    def preprocess(left, right):
        return (remap_bilinear(left, *maps[0]),
                remap_bilinear(right, *maps[1]))
    return preprocess


def main(argv=None, rospy_module=None, image_cls=None) -> int:
    args = parse_command(__doc__, ["path_to_vocabulary", "path_to_settings",
                                   "do_rectify"], argv)
    cfg = load_settings(args.path_to_settings, Sensor.STEREO)
    preprocess = None
    if args.do_rectify.lower() == "true":
        preprocess = make_rectifier(cfg)
        if preprocess is None:
            print("ERROR: Calibration parameters to rectify stereo are "
                  "missing!", file=sys.stderr)
            return 1
    rospy, image_cls = _import_rospy(rospy_module, image_cls)
    slam = System(cfg, Sensor.STEREO, device=args.device,
                  vocabulary_path=args.vocabulary, async_mapping=True)
    attach_rospy_pair(RosStereoBridge(slam), "/camera/left/image_raw",
                      "/camera/right/image_raw", node_name="Stereo",
                      rospy_module=rospy, image_cls=image_cls,
                      preprocess=preprocess)
    rospy.spin()
    slam.shutdown()
    slam.save_trajectory_tum("CameraTrajectory.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
