"""A kernel's share of its roofline in the traced sub-window.

The bound of each launch comes from the kernel's count file
(kernels/<kernel>.py: the bytes and operations the launch's inputs need,
whatever implements it) at the H100's published peaks; the time is the
kernel's own device time, found by name in the trace. The share is the
bounds' sum over the kernels' device time. Nothing is read where the
trace holds no launch of the kernel or lost some of its records.
"""

from __future__ import annotations

import sys

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, float32 operations/s
# outside the tensor cores (at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def share(ctx, kernel: str):
    trace = ctx.trace
    if trace is None:
        return None
    k = ctx.registry.kernel(kernel)
    dev_s, n = trace.device_seconds(k.TRACE_NAME)
    launches = len(ctx.traced_images) * k.LAUNCHES_PER_FRAME_BUILD
    if n == 0 or n != launches:
        print(f"{kernel}: {n} launches in the trace, {launches} expected; "
              f"no roofline read", file=sys.stderr)
        return None
    bound = sum(bound_s(*k.count(imgs, ctx.cfg, ctx.device))
                for imgs in ctx.traced_images)
    return 100.0 * bound / dev_s
