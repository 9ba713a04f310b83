"""Configuration system.

Preserves the reference's OpenCV-YAML settings schema (keys read in
reference src/Tracking.cc:32-96, src/Viewer.cc:13-31, src/MapDrawer.cc:11-19)
so the reference's per-dataset yaml files are drop-in usable, while exposing a
typed dataclass for the rest of the framework.

Sensor enum values match reference include/System.h:32-36 (MONOCULAR=0,
STEREO=1, RGBD=2).
"""

from __future__ import annotations

import dataclasses
import enum
import math
import re
from typing import Optional

import numpy as np


class Sensor(enum.IntEnum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class TrackingState(enum.IntEnum):
    """Tracking state machine values (reference include/Tracking.h:62-68)."""

    SYSTEM_NOT_READY = -1
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0          # stereo baseline * fx (reference Tracking.cc:58)
    fps: float = 30.0
    rgb: bool = True         # Camera.RGB: input channel order
    width: int = 640
    height: int = 480

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def dist_coeffs(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], dtype=np.float32)

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB extractor parameters (reference src/Tracking.cc:64-82).

    n_features is padded up to a multiple of 128 internally for MXU-friendly
    static shapes; `valid` masks carry the true count.
    """

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    def per_level_features(self) -> list[int]:
        """Geometric split of the feature budget over pyramid levels.

        Mirrors the contract of reference src/ORBextractor.cc:141-151: level 0
        gets the largest share, each level scaled down by 1/scale_factor, with
        the remainder dumped on the last level.
        """
        factor = 1.0 / self.scale_factor
        n_desired = self.n_features * (1.0 - factor) / (
            1.0 - factor ** self.n_levels
        )
        counts = []
        total = 0
        for _ in range(self.n_levels - 1):
            c = int(round(n_desired))
            counts.append(c)
            total += c
            n_desired *= factor
        counts.append(max(self.n_features - total, 0))
        return counts

    def level_scales(self) -> list[float]:
        return [self.scale_factor ** i for i in range(self.n_levels)]


@dataclasses.dataclass(frozen=True)
class ViewerConfig:
    keyframe_size: float = 0.05
    keyframe_line_width: float = 1.0
    graph_line_width: float = 0.9
    point_size: float = 2.0
    camera_size: float = 0.08
    camera_line_width: float = 3.0
    viewpoint_x: float = 0.0
    viewpoint_y: float = -0.7
    viewpoint_z: float = -1.8
    viewpoint_f: float = 500.0


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    viewer: ViewerConfig = dataclasses.field(default_factory=ViewerConfig)
    sensor: Sensor = Sensor.MONOCULAR
    th_depth: float = 35.0          # close/far depth threshold, metres
    depth_map_factor: float = 1.0   # RGB-D depth scaling (DepthMapFactor)
    # Stereo rectification blocks (stereo_euroc-style LEFT/RIGHT.{K,D,R,P}).
    rect_left: Optional[dict] = None
    rect_right: Optional[dict] = None


_YAML_SCALAR = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(.+?)\s*(#.*)?$")


def _parse_opencv_yaml(path: str) -> dict:
    """Parse the subset of OpenCV YAML used by the reference settings files.

    Handles `Key.Sub: value` scalars and `!!opencv-matrix` blocks with
    rows/cols/dt/data (used by stereo_euroc LEFT/RIGHT.* blocks, reference
    Examples/Stereo/stereo_euroc.cc:60-98). No external YAML dependency.
    """
    out: dict = {}
    with open(path, "r") as f:
        text = f.read()
    # Strip the %YAML directive line if present.
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    i = 0
    while i < len(lines):
        line = lines[i]
        if "!!opencv-matrix" in line:
            key = line.split(":")[0].strip()
            block = {"rows": 0, "cols": 0, "data": []}
            i += 1
            data_text = ""
            in_data = False
            while i < len(lines):
                ln = lines[i]
                if re.match(r"^\S", ln) and ":" in ln and not in_data:
                    break
                s = ln.strip()
                if s.startswith("rows:"):
                    block["rows"] = int(s.split(":")[1])
                elif s.startswith("cols:"):
                    block["cols"] = int(s.split(":")[1])
                elif s.startswith("data:"):
                    in_data = True
                    data_text += s.split(":", 1)[1]
                    if "]" in data_text:
                        break
                elif in_data:
                    data_text += " " + s
                    if "]" in s:
                        break
                i += 1
            nums = re.findall(r"[-+0-9.eE]+", data_text)
            block["data"] = np.array([float(x) for x in nums], dtype=np.float64)
            if block["rows"] and block["cols"]:
                block["data"] = block["data"].reshape(block["rows"], block["cols"])
            out[key] = block["data"]
            i += 1
            continue
        m = _YAML_SCALAR.match(line)
        if m:
            key, val = m.group(1), m.group(2)
            try:
                out[key] = float(val) if ("." in val or "e" in val or "E" in val) else int(val)
            except ValueError:
                out[key] = val
        i += 1
    return out


def th_depth_metres(th_depth: float, cam: CameraConfig, sensor: Sensor) -> float:
    """A settings file's ThDepth in metres. The reference reads it in units
    of the stereo baseline for the stereo and RGB-D sensors (Tracking
    constructor: mThDepth = bf * ThDepth / fx); SlamConfig.th_depth is in
    metres, the unit the tracker compares depths in. (The JAX package stores
    the file's number as metres: 35 m for KITTI 00-02 where the reference
    uses 18.8 m.) A monocular load keeps the number."""
    if sensor == Sensor.MONOCULAR or cam.fx == 0.0:
        return th_depth
    return cam.bf * th_depth / cam.fx


def load_settings(path: str, sensor: Sensor = Sensor.MONOCULAR) -> SlamConfig:
    """Load a reference-format settings yaml into a SlamConfig.

    Key set mirrors reference src/Tracking.cc:32-96. ThDepth comes out in
    metres (th_depth_metres).
    """
    d = _parse_opencv_yaml(path)

    def g(key, default):
        return d.get(key, default)

    cam = CameraConfig(
        fx=float(g("Camera.fx", 0.0)),
        fy=float(g("Camera.fy", 0.0)),
        cx=float(g("Camera.cx", 0.0)),
        cy=float(g("Camera.cy", 0.0)),
        k1=float(g("Camera.k1", 0.0)),
        k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)),
        p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        bf=float(g("Camera.bf", 0.0)),
        fps=float(g("Camera.fps", 30.0)) or 30.0,
        rgb=bool(int(g("Camera.RGB", 1))),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
    )
    orb = ORBConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    viewer = ViewerConfig(
        keyframe_size=float(g("Viewer.KeyFrameSize", 0.05)),
        keyframe_line_width=float(g("Viewer.KeyFrameLineWidth", 1.0)),
        graph_line_width=float(g("Viewer.GraphLineWidth", 0.9)),
        point_size=float(g("Viewer.PointSize", 2.0)),
        camera_size=float(g("Viewer.CameraSize", 0.08)),
        camera_line_width=float(g("Viewer.CameraLineWidth", 3.0)),
        viewpoint_x=float(g("Viewer.ViewpointX", 0.0)),
        viewpoint_y=float(g("Viewer.ViewpointY", -0.7)),
        viewpoint_z=float(g("Viewer.ViewpointZ", -1.8)),
        viewpoint_f=float(g("Viewer.ViewpointF", 500.0)),
    )
    rect_left = rect_right = None
    if "LEFT.K" in d:
        rect_left = {k.split(".", 1)[1]: d[k] for k in d if k.startswith("LEFT.")}
        rect_right = {k.split(".", 1)[1]: d[k] for k in d if k.startswith("RIGHT.")}
    return SlamConfig(
        camera=cam,
        orb=orb,
        viewer=viewer,
        sensor=sensor,
        th_depth=th_depth_metres(float(g("ThDepth", 35.0)), cam, sensor),
        depth_map_factor=float(g("DepthMapFactor", 1.0)) or 1.0,
        rect_left=rect_left,
        rect_right=rect_right,
    )


def save_settings_yaml(cfg: SlamConfig, path: str):
    """Write a SlamConfig as a reference-format OpenCV settings yaml
    (inverse of load_settings; same key set as reference
    src/Tracking.cc:32-96, ThDepth back in baseline units for the stereo and
    RGB-D sensors). Round-trips through load_settings."""
    cam, orb, vw = cfg.camera, cfg.orb, cfg.viewer
    th_depth = cfg.th_depth
    if cfg.sensor != Sensor.MONOCULAR and cam.bf != 0.0:
        th_depth = th_depth * cam.fx / cam.bf
    lines = ["%YAML:1.0", ""]
    for k, v in (
        ("Camera.fx", cam.fx), ("Camera.fy", cam.fy),
        ("Camera.cx", cam.cx), ("Camera.cy", cam.cy),
        ("Camera.k1", cam.k1), ("Camera.k2", cam.k2),
        ("Camera.p1", cam.p1), ("Camera.p2", cam.p2),
        ("Camera.k3", cam.k3), ("Camera.bf", cam.bf),
        ("Camera.fps", cam.fps), ("Camera.RGB", int(cam.rgb)),
        ("Camera.width", cam.width), ("Camera.height", cam.height),
        ("ThDepth", th_depth), ("DepthMapFactor", cfg.depth_map_factor),
        ("ORBextractor.nFeatures", orb.n_features),
        ("ORBextractor.scaleFactor", orb.scale_factor),
        ("ORBextractor.nLevels", orb.n_levels),
        ("ORBextractor.iniThFAST", orb.ini_th_fast),
        ("ORBextractor.minThFAST", orb.min_th_fast),
        ("Viewer.KeyFrameSize", vw.keyframe_size),
        ("Viewer.KeyFrameLineWidth", vw.keyframe_line_width),
        ("Viewer.GraphLineWidth", vw.graph_line_width),
        ("Viewer.PointSize", vw.point_size),
        ("Viewer.CameraSize", vw.camera_size),
        ("Viewer.CameraLineWidth", vw.camera_line_width),
        ("Viewer.ViewpointX", vw.viewpoint_x),
        ("Viewer.ViewpointY", vw.viewpoint_y),
        ("Viewer.ViewpointZ", vw.viewpoint_z),
        ("Viewer.ViewpointF", vw.viewpoint_f),
    ):
        lines.append(f"{k}: {v}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
