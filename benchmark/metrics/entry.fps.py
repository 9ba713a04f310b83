"""entry.fps: frames completed in the window over the window's whole time,
as the end-to-end fps was read before the host's speed made it too unsteady
for any bound allowed (PERF.md section 2). In a traced run the window holds
the profiled frames too."""


def read(ctx):
    if not ctx.frames or ctx.window_s <= 0:
        return None
    return ctx.frames / ctx.window_s
