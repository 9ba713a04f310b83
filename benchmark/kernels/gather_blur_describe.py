"""Kernel B in describe mode (orb_slam_system_tpu_torch/csrc/
gather_blur_moments.cu, gather_blur_moments_kernel<true>): from the
all-level canvas to each keypoint slot's IC moments, angle and steered
rBRIEF descriptor in one launch.

Count: the canvas floats inside the slots' clipped 43x43 windows, as the
benchmark's reference extractor places them on these images, read once;
each slot's centre read and its moments, angle and descriptor (11 words)
written once; per slot the first blur pass over 37x43 samples, the second
at the 512 test points, the moments over the 749-pixel circle, and two
bf16 roundings and a compare per test."""

import torch

from reference import orb

TRACE_NAME = "gather_blur_moments_kernel<true>"
LAUNCHES_PER_FRAME_BUILD = 1


def count(images, cfg: dict, device) -> tuple:
    """(bytes, operations) of one launch over images u8[B, H, W]."""
    o = cfg["orb"]
    ref = orb.extract(torch.as_tensor(images).to(device), int(o["n_features"]),
                      float(o["scale_factor"]), int(o["n_levels"]),
                      int(o["ini_th_fast"]), int(o["min_th_fast"]))
    n_kp = ref.valid.numel()
    n_read = sum(ref.canvas_floats_read)
    side = 2 * orb.PATCH_RADIUS + 1
    ops = n_kp * (2 * 7 * side * (side + 6) + 2 * 7 * 512 + 4 * 749) + 3.0 * 256 * n_kp
    return 4.0 * (n_read + 2 * n_kp + 11 * n_kp), float(ops)
