"""Kernel B's describe mode: its share of its roofline in the traced frames."""

from harness.roofline import share


def read(ctx):
    return share(ctx, "gather_blur_describe")
