"""Kernels the card ran in the traced sub-window per frame completed in it
(all cameras' frames)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / (t.frames * ctx.n_cams)
