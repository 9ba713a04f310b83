"""Replay image messages through the ROS nodes without ROS.

`ReplayRospy` stands in for the part of rospy the nodes touch
(drivers/ros_*.py): `init_node` records the node's name, `Subscriber`
registers a callback per topic, and `spin` delivers a scripted list of
(topic, message) pairs in order, then returns as rospy.spin does at
shutdown. `ImageMsg` is a duck-typed sensor_msgs/Image that
dataio/ros_bridge.decode_image_msg reads. Pass both to a node's main
(`main(argv, rospy_module=ReplayRospy(script), image_cls=ImageMsg)`) to
run it on recorded or rendered frames.
"""

from __future__ import annotations

import numpy as np

# Bytes and dtype per pixel of each encoding ImageMsg.from_array writes.
ENCODINGS = {"mono8": (np.uint8, 1), "mono16": (np.uint16, 1),
             "rgb8": (np.uint8, 3), "bgr8": (np.uint8, 3),
             "rgba8": (np.uint8, 4), "bgra8": (np.uint8, 4),
             "32FC1": (np.float32, 1)}


class _Stamp:
    def __init__(self, t: float):
        self._t = t

    def to_sec(self) -> float:
        return self._t


class _Header:
    def __init__(self, t: float):
        self.stamp = _Stamp(t)


class ImageMsg:
    """sensor_msgs/Image's fields: height, width, encoding, step, data and
    header.stamp.to_sec()."""

    def __init__(self, height, width, encoding, step, data: bytes, t: float):
        self.height, self.width = height, width
        self.encoding, self.step, self.data = encoding, step, data
        self.header = _Header(t)

    @classmethod
    def from_array(cls, arr: np.ndarray, t: float, encoding: str = "mono8",
                   pad: int = 0) -> "ImageMsg":
        """A message holding arr ([H,W] or [H,W,C] of the encoding's dtype
        and channels, e.g. u8 [H,W] for mono8, f32 [H,W] depth for 32FC1),
        each row followed by `pad` zero bytes (step = row bytes + pad)."""
        dtype, ch = ENCODINGS[encoding]
        arr = np.ascontiguousarray(arr, dtype=dtype)
        h, w = arr.shape[:2]
        if arr.size != h * w * ch:
            raise ValueError(f"{encoding} needs {ch} channel(s), got "
                             f"{arr.shape}")
        rows = arr.reshape(h, -1).view(np.uint8)
        padded = np.zeros((h, rows.shape[1] + pad), np.uint8)
        padded[:, :rows.shape[1]] = rows
        return cls(h, w, encoding, padded.shape[1], padded.tobytes(), t)

    @classmethod
    def mono8(cls, img: np.ndarray, t: float) -> "ImageMsg":
        """A gray frame (any float or int array) as mono8, clipped to
        [0, 255]."""
        return cls.from_array(np.clip(img, 0, 255).astype(np.uint8), t)


class ReplayRospy:
    """The rospy surface of the nodes, replaying `script`, a list of
    (topic, message), inside spin()."""

    def __init__(self, script):
        self.script = list(script)
        self.subs = {}
        self.node_name = None

    def init_node(self, name, anonymous=False):
        self.node_name = name

    def Subscriber(self, topic, msg_cls, cb, queue_size=1):
        self.subs[topic] = cb
        return ("sub", topic)

    def spin(self):
        for topic, msg in self.script:
            if topic not in self.subs:
                raise KeyError(f"no subscriber for {topic}")
            self.subs[topic](msg)
