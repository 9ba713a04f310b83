"""Kernel A's share of its roofline in the traced frames."""

from harness.roofline import share


def read(ctx):
    return share(ctx, "fast_score_nms")
