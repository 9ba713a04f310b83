"""Synthetic sequences written in the datasets' on-disk layouts, for the
readers in dataio/datasets.py and the drivers: TUM (mono and RGB-D),
KITTI odometry and EuRoC (mono and stereo), each with its ground
truth. Images go out as PNG through models/viewer.encode_png (16-bit
grayscale for depth), so a sequence needs no image library to write or
read. The tests and chip_smoke.py drive the dataset entry points on them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from orb_slam_system_tpu_torch.models.viewer import encode_png
from orb_slam_system_tpu_torch.utils.lie import quat_from_rot


def _png(path: str, img: np.ndarray):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _lines(path: str, lines: Sequence[str]):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def tum_pose_line(t: float, Tcw: np.ndarray) -> str:
    """`t tx ty tz qx qy qz qw` of the camera-to-world pose (TUM format)."""
    Rwc = Tcw[:3, :3].T.astype(np.float64)
    c = -Rwc @ Tcw[:3, 3]
    q = quat_from_rot(Rwc)
    return (f"{t:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}")


def write_tum(seq_dir: str, frames: List[np.ndarray], times: List[float],
              poses: List[np.ndarray],
              depths: Optional[List[np.ndarray]] = None):
    """rgb/<t>.png with rgb.txt and groundtruth.txt (three comment lines
    each, as TUM's); with `depths` (u16 maps in DepthMapFactor units) also
    depth/<t>.png, depth.txt and associations.txt."""
    rgb = ["# color images", "# synthetic", "# timestamp filename"]
    dep = ["# depth maps", "# synthetic", "# timestamp filename"]
    gt = ["# ground truth trajectory", "# synthetic",
          "# timestamp tx ty tz qx qy qz qw"]
    assoc = []
    for i, (t, T) in enumerate(zip(times, poses)):
        name = f"rgb/{t:.6f}.png"
        _png(os.path.join(seq_dir, name), frames[i])
        rgb.append(f"{t:.6f} {name}")
        gt.append(tum_pose_line(t, T))
        if depths is not None:
            dname = f"depth/{t:.6f}.png"
            _png(os.path.join(seq_dir, dname), depths[i].astype(np.uint16))
            dep.append(f"{t:.6f} {dname}")
            assoc.append(f"{t:.6f} {name} {t:.6f} {dname}")
    _lines(os.path.join(seq_dir, "rgb.txt"), rgb)
    _lines(os.path.join(seq_dir, "groundtruth.txt"), gt)
    if depths is not None:
        _lines(os.path.join(seq_dir, "depth.txt"), dep)
        _lines(os.path.join(seq_dir, "associations.txt"), assoc)


def write_kitti(seq_dir: str, lefts: List[np.ndarray], times: List[float],
                poses: List[np.ndarray],
                rights: Optional[List[np.ndarray]] = None) -> str:
    """image_0/%06d.png (and image_1/ for `rights`) with times.txt, and the
    ground truth in KITTI's poses format (3x4 row-major Twc per line) at
    poses.txt, whose path is returned."""
    for i, img in enumerate(lefts):
        _png(os.path.join(seq_dir, "image_0", f"{i:06d}.png"), img)
        if rights is not None:
            _png(os.path.join(seq_dir, "image_1", f"{i:06d}.png"), rights[i])
    _lines(os.path.join(seq_dir, "times.txt"), [f"{t:.6e}" for t in times])
    rows = []
    for T in poses:
        Twc = np.linalg.inv(T.astype(np.float64))[:3]
        rows.append(" ".join(f"{v:.9e}" for v in Twc.reshape(-1)))
    path = os.path.join(seq_dir, "poses.txt")
    _lines(path, rows)
    return path


def write_euroc(seq_dir: str, frames: List[np.ndarray], times_ns: List[int],
                poses: List[np.ndarray],
                rights: Optional[List[np.ndarray]] = None) -> str:
    """mav0/cam0/data/<ns>.png (and mav0/cam1/ for `rights`), a timestamp
    file of one ns value per line (EuRoC_TimeStamps' format) at
    timestamps.txt, whose path is returned, and groundtruth.txt in TUM
    format (seconds)."""
    for i, ns in enumerate(times_ns):
        _png(os.path.join(seq_dir, "mav0", "cam0", "data", f"{ns}.png"),
             frames[i])
        if rights is not None:
            _png(os.path.join(seq_dir, "mav0", "cam1", "data", f"{ns}.png"),
                 rights[i])
    path = os.path.join(seq_dir, "timestamps.txt")
    _lines(path, [str(ns) for ns in times_ns])
    _lines(os.path.join(seq_dir, "groundtruth.txt"),
           [tum_pose_line(ns * 1e-9, T) for ns, T in zip(times_ns, poses)])
    return path
