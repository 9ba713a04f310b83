"""ROS-style bridge adapters (dependency-gated).

Copy of orb_slam_system_tpu/dataio/ros_bridge.py for the port. The
reference ships 4 ROS nodes (Examples/ROS/ORB_SLAM2/src/ros_{mono,rgbd,
stereo}.cc + the AR demo) that subscribe to image topics and call the
System per message. This module provides the same callback-shaped surface:
construct a bridge with a System, hand its `on_*` methods to any message
source (rospy subscriber, rosbag reader, or a test harness). rospy itself
is optional — `attach_rospy` only imports it on use.

Messages decode on the host with numpy (`decode_image_msg`), as a dataset
frame does; the port's System uploads the image and runs its kernels in
`track_monocular` / `track_stereo` / `track_rgbd`.
"""

from __future__ import annotations

import numpy as np


class RosMonoBridge:
    """Reference ros_mono.cc: subscribes /camera/image_raw (:64), calls
    TrackMonocular per message."""

    def __init__(self, system):
        self.system = system

    def on_image(self, img: np.ndarray, stamp_sec: float):
        return self.system.track_monocular(img, stamp_sec)


class RosStereoBridge:
    """Reference ros_stereo.cc: synchronized left/right image topics."""

    def __init__(self, system):
        self.system = system

    def on_images(self, left: np.ndarray, right: np.ndarray, stamp_sec: float):
        return self.system.track_stereo(left, right, stamp_sec)


class RosRGBDBridge:
    """Reference ros_rgbd.cc: synchronized rgb + depth topics."""

    def __init__(self, system):
        self.system = system

    def on_images(self, rgb: np.ndarray, depth: np.ndarray, stamp_sec: float):
        return self.system.track_rgbd(rgb, depth, stamp_sec)


def decode_image_msg(msg) -> np.ndarray:
    """Decode a sensor_msgs/Image into a float32 grayscale array without
    cv_bridge (mono8/mono16/rgb8/bgr8/rgba8/bgra8/32FC1), honoring
    msg.step row strides. Works on any object with height/width/encoding/
    step/data attributes, so it is unit-testable without ROS."""
    h, w, step = int(msg.height), int(msg.width), int(msg.step)
    buf = np.frombuffer(bytes(msg.data), np.uint8)
    enc = msg.encoding.lower()
    if enc in ("mono8", "8uc1"):
        img = buf.reshape(h, step)[:, :w].astype(np.float32)
    elif enc in ("mono16", "16uc1"):
        rows = buf.reshape(h, step)[:, :2 * w]
        img = rows.view(np.uint16).reshape(h, w).astype(np.float32) / 257.0
    elif enc in ("rgb8", "bgr8", "rgba8", "bgra8"):
        c = 4 if "a8" in enc else 3
        rows = buf.reshape(h, step)[:, :c * w].reshape(h, w, c)
        r, g, b = ((rows[..., 2], rows[..., 1], rows[..., 0])
                   if enc.startswith("bgr") else
                   (rows[..., 0], rows[..., 1], rows[..., 2]))
        img = (0.299 * r + 0.587 * g + 0.114 * b).astype(np.float32)
    elif enc == "32fc1":
        rows = buf.reshape(h, step)[:, :4 * w]
        img = rows.view(np.float32).reshape(h, w).copy()
    else:
        raise ValueError(f"unsupported image encoding: {msg.encoding}")
    return img


class ApproxTimeSync:
    """Two-stream approximate-time pairing (the reference nodes use
    message_filters::sync_policies::ApproximateTime over left/right and
    rgb/depth topics, Examples/ROS/ORB_SLAM2/src/ros_stereo.cc:113-117 /
    ros_rgbd.cc:64-68): feed messages per stream; when the head-of-queue
    stamps agree within `slop` seconds the callback fires with the pair."""

    def __init__(self, callback, slop: float = 0.05, queue_size: int = 10):
        self.callback = callback
        self.slop = slop
        self.queue_size = queue_size
        self._q = ([], [])

    def add(self, stream: int, msg, stamp_sec: float):
        q = self._q[stream]
        q.append((stamp_sec, msg))
        if len(q) > self.queue_size:
            q.pop(0)
        self._try_emit()

    def _try_emit(self):
        qa, qb = self._q
        while qa and qb:
            ta, tb = qa[0][0], qb[0][0]
            if abs(ta - tb) <= self.slop:
                a = qa.pop(0)[1]
                b = qb.pop(0)[1]
                self.callback(a, b, min(ta, tb))
            elif ta < tb:
                qa.pop(0)
            else:
                qb.pop(0)


def _import_rospy(rospy_module=None, image_cls=None):
    """Injectable imports: tests drive the node lifecycle with a stub."""
    if rospy_module is None:
        import rospy  # noqa: deferred, optional dependency
        rospy_module = rospy
    if image_cls is None:
        from sensor_msgs.msg import Image  # noqa: deferred
        image_cls = Image
    return rospy_module, image_cls


def attach_rospy(bridge, image_topic: str = "/camera/image_raw",
                 node_name: str = "orb_slam_tpu",
                 rospy_module=None, image_cls=None,
                 on_result=None):
    """Wire a RosMonoBridge to a live rospy subscriber (requires rospy at
    runtime; import-gated so the package has no hard ROS dep; pass
    rospy_module/image_cls to inject a test stub). Decoding uses
    decode_image_msg, so cv_bridge is not needed."""
    rospy, Image = _import_rospy(rospy_module, image_cls)

    def cb(msg):
        r = bridge.on_image(decode_image_msg(msg), msg.header.stamp.to_sec())
        if on_result is not None:
            on_result(r)

    rospy.init_node(node_name, anonymous=True)
    return rospy.Subscriber(image_topic, Image, cb, queue_size=1)


def attach_rospy_pair(bridge, topic_a: str, topic_b: str,
                      node_name: str = "orb_slam_tpu",
                      rospy_module=None, image_cls=None,
                      slop: float = 0.05, on_result=None,
                      preprocess=None):
    """Wire a RosStereoBridge / RosRGBDBridge to two synchronized image
    topics (reference ros_stereo.cc / ros_rgbd.cc message_filters setup).
    `preprocess(img_a, img_b) -> (img_a, img_b)` hooks stereo
    rectification in front of tracking."""
    rospy, Image = _import_rospy(rospy_module, image_cls)

    def emit(msg_a, msg_b, stamp):
        a = decode_image_msg(msg_a)
        b = decode_image_msg(msg_b)
        if preprocess is not None:
            a, b = preprocess(a, b)
        r = bridge.on_images(a, b, stamp)
        if on_result is not None:
            on_result(r)

    sync = ApproxTimeSync(emit, slop=slop)
    rospy.init_node(node_name, anonymous=True)
    subs = (
        rospy.Subscriber(
            topic_a, Image,
            lambda m: sync.add(0, m, m.header.stamp.to_sec()),
            queue_size=1),
        rospy.Subscriber(
            topic_b, Image,
            lambda m: sync.add(1, m, m.header.stamp.to_sec()),
            queue_size=1),
    )
    return subs, sync
