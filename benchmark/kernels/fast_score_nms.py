"""Kernel A (orb_slam_system_tpu_torch/csrc/fast_score_nms.cu): the dense
FAST-9 score, border mask and 3x3 non-maximum suppression of every
pyramid level of a batch of images, in one launch.

Count: each level's pixel read once and its result written once (4 bytes
each), and per pixel 16 ring differences, 97 min/max for the segment test
and 9 max for the suppression (122 operations; the first design's ~330
did more work than the inputs need)."""

TRACE_NAME = "fast_score_nms_kernel"
LAUNCHES_PER_FRAME_BUILD = 1
OPS_PER_PIXEL = 16 + 97 + 9


def pixels(batch: int, height: int, width: int, n_levels: int, scale: float) -> int:
    return batch * sum(int(round(height / scale ** l)) * int(round(width / scale ** l))
                       for l in range(n_levels))


def count(images, cfg: dict, device) -> tuple:
    """(bytes, operations) of one launch over images u8[B, H, W]."""
    B, H, W = images.shape
    px = pixels(B, H, W, int(cfg["orb"]["n_levels"]), float(cfg["orb"]["scale_factor"]))
    return 8.0 * px, float(OPS_PER_PIXEL) * px
