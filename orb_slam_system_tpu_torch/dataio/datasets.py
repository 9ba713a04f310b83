"""Dataset readers: TUM RGB-D, KITTI odometry, EuRoC MAV.

Copy of orb_slam_system_tpu/dataio/datasets.py for the port. File-format
parity with the reference drivers:
  * TUM `rgb.txt` (3 header lines, `timestamp path` rows) —
    mono_tum.cc:128-155 LoadImages.
  * TUM association files (`t_rgb rgb t_depth depth`) — rgbd_tum.cc
    LoadImages.
  * KITTI `sequences/NN/image_0/%06d.png` + `times.txt` — mono_kitti.cc /
    stereo_kitti.cc LoadImages.
  * EuRoC `mav0/cam0/data/` + timestamp list files — mono_euroc.cc /
    stereo_euroc.cc LoadImages.

Images decode through the port's native decoder (native/: zlib PNG and
PGM/PPM), which raises when it cannot build or decode. Unlike the JAX
package (datasets.py:28-76) there is no PIL, torchvision or pure-Python
fallback on this path; `_load_pnm` stays as the independent reader the
tests hold the native decoder against.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from orb_slam_system_tpu_torch import native


# ---------------------------------------------------------------------------
# Image loading
# ---------------------------------------------------------------------------

def load_image_gray(path: str) -> np.ndarray:
    """Returns f32[H,W] grayscale in [0,255] (RGB converted with the
    0.299 / 0.587 / 0.114 weights)."""
    return native.decode_gray(path)


def load_depth_raw(path: str) -> np.ndarray:
    """16-bit depth image as RAW values f32[H,W] (no [0,255] rescaling —
    DepthMapFactor in the settings yaml converts to meters, reference
    src/Tracking.cc:90-96)."""
    return native.decode_gray(path, raw16=True)


def _load_pnm(path: str, raw: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # Parse header tokens (magic, width, height, maxval), skipping comments.
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic = tokens[0].decode()
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    if magic == "P5":
        arr = np.frombuffer(data, dtype=dtype, count=w * h, offset=i)
        img = arr.reshape(h, w).astype(np.float32)
    elif magic == "P6":
        arr = np.frombuffer(data, dtype=dtype, count=w * h * 3, offset=i)
        rgb = arr.reshape(h, w, 3).astype(np.float32)
        img = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    else:
        raise ValueError(f"unsupported PNM magic {magic} in {path}")
    if maxval >= 256 and not raw:
        img = img * (255.0 / maxval)
    return img


# ---------------------------------------------------------------------------
# Sequence listings
# ---------------------------------------------------------------------------

def load_tum_rgb(seq_dir: str) -> Tuple[List[str], List[float]]:
    """Parse `rgb.txt` (reference mono_tum.cc:128-155: skip 3 header lines)."""
    paths, times = [], []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, rel = line.split()[:2]
            times.append(float(t))
            paths.append(os.path.join(seq_dir, rel))
    return paths, times


def load_tum_associations(seq_dir: str, assoc_file: str):
    """rgbd_tum association file: `t_rgb rgb t_depth depth` per line."""
    rgb, depth, times = [], [], []
    with open(assoc_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            times.append(float(p[0]))
            rgb.append(os.path.join(seq_dir, p[1]))
            depth.append(os.path.join(seq_dir, p[3]))
    return rgb, depth, times


def load_kitti(seq_dir: str, stereo: bool = False):
    """KITTI odometry: times.txt + image_0 (and image_1 for stereo),
    %06d.png (reference mono_kitti.cc / stereo_kitti.cc LoadImages)."""
    times = []
    with open(os.path.join(seq_dir, "times.txt")) as f:
        for line in f:
            line = line.strip()
            if line:
                times.append(float(line))
    left = [os.path.join(seq_dir, "image_0", f"{i:06d}.png")
            for i in range(len(times))]
    if not stereo:
        return left, times
    right = [os.path.join(seq_dir, "image_1", f"{i:06d}.png")
             for i in range(len(times))]
    return left, right, times


def load_euroc(cam_dir: str, timestamp_file: str):
    """EuRoC: images under cam_dir/data/ named <ns>.png, frame list in a
    timestamp file with one ns value per line (reference mono_euroc.cc)."""
    paths, times = [], []
    with open(timestamp_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ns = line.split(".")[0].split(",")[0]
            paths.append(os.path.join(cam_dir, "data", ns + ".png"))
            times.append(float(ns) * 1e-9)
    return paths, times


def load_tum_groundtruth(path: str) -> dict:
    """TUM groundtruth.txt: `t tx ty tz qx qy qz qw` -> {t: position}."""
    gt = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = [float(x) for x in line.split()]
            gt[p[0]] = np.asarray(p[1:4])
    return gt
