"""A profiled sub-window: device intervals, kernels by name, idle gaps.

torch.profiler (CUPTI) traces a few frames inside the measured window. The
records are read straight from the profiler's results, without writing a
trace file. The card's records can be lost at a window's start, so the
window opens with spin kernels and a synchronize; they are left out of
every count, and the kernels launched by the host are counted beside the
kernels the card reported, so a loss shows as "records lost".
"""

from __future__ import annotations

import sys

from harness.stats import merged, union_seconds

SPIN_KERNELS = 64
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def _ns(ev, which: str) -> int:
    if which == "start":
        return ev.start_ns() if hasattr(ev, "start_ns") else int(ev.start_us() * 1e3)
    return ev.duration_ns() if hasattr(ev, "duration_ns") else int(ev.duration_us() * 1e3)


class Trace:
    """What one profiled sub-window holds, in seconds from its start."""

    def __init__(self, device_ops, host_ops, t0_ns: int, t1_ns: int,
                 launches: int, frames: int):
        self.window_s = (t1_ns - t0_ns) * 1e-9
        self.device_ops = device_ops      # [(name, start_s, end_s)]
        self.host_ops = host_ops          # [(name, start_s, end_s)]
        self.launches = launches
        self.frames = frames

    @property
    def kernels(self):
        return [o for o in self.device_ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    @property
    def busy_s(self) -> float:
        return union_seconds((s, e) for _n, s, e in self.device_ops)

    @property
    def records_lost(self) -> int:
        return max(self.launches - len(self.kernels), 0)

    def device_seconds(self, name_part: str):
        """(total device seconds, count) of the kernels whose name holds
        name_part."""
        ks = [e - s for n, s, e in self.kernels if name_part in n]
        return sum(ks), len(ks)

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for n, s, e in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged((s, e) for _n, s, e in self.device_ops)
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        if busy:
            gaps = [(0.0, busy[0][0])] + gaps + [(busy[-1][1], self.window_s)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[_short(n), t] for n, t in ops],
                "idle_gaps": [[self.host_doing((s + e) / 2), e - s]
                              for s, e in gaps]}

    def host_doing(self, t: float) -> str:
        """The innermost host operation running at t; where none runs, the
        host is in Python between the last operation to end before t and
        the first to start after it."""
        best = None
        before = after = None
        for n, s, e in self.host_ops:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (n, e - s)
            if e < t and (before is None or e > before[1]):
                before = (n, e)
            if s > t and (after is None or s < after[1]):
                after = (n, s)
        if best:
            return _short(best[0])
        return (f"Python after {_short(before[0]) if before else 'start'} "
                f"before {_short(after[0]) if after else 'end'}")


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    return name.split("(")[0].strip()[:120]


def profile_frames(torch, run_frames, n_frames: int) -> Trace:
    """Profile run_frames() (which hands in n_frames frames) on the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SPIN_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with torch.profiler.record_function("bench.subwindow"):
            run_frames()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == "bench.subwindow"]
    if not mark:
        raise RuntimeError("the profiler lost the sub-window's own marker")
    t0 = _ns(mark[0], "start")
    t1 = t0 + _ns(mark[0], "dur")
    dev, host, launches, unnamed = [], [], 0, 0
    for e in events:
        s = _ns(e, "start")
        if s < t0 or s > t1:
            continue
        rec = (e.name(), (s - t0) * 1e-9, (s - t0 + _ns(e, "dur")) * 1e-9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # The marker's own device-side annotation and unnamed
            # annotations are not operations.
            if e.name() and e.name() != "bench.subwindow" and "spin" not in e.name():
                dev.append(rec)
            elif not e.name():
                unnamed += 1
        elif e.name() != "bench.subwindow":
            host.append(rec)
            if e.name() in _LAUNCH_CALLS:
                launches += 1
    trace = Trace(dev, host, t0, t1, launches, n_frames)
    print(f"trace: {len(trace.kernels)} kernels on the card, {launches} "
          f"launched by the host, records lost {trace.records_lost}, "
          f"{trace.window_s:.3f} s traced over {n_frames} frames, "
          f"{unnamed} unnamed device records left out",
          file=sys.stderr, flush=True)
    return trace


class KernelMeter:
    """The card's kernel time over a whole window, for an end-to-end metric
    on the device's clock: the window's frames run inside back-to-back
    profiler sessions of about `chunk_s` seconds each (CUDA activity only),
    and each session's records are read and dropped when it closes, so no
    session holds more than a few seconds of kernels. Opening a session
    (spin kernels and a synchronize, as for a sub-window) and reading one
    are the harness's own work: `open` and `close` return the seconds they
    took, which the window leaves out. The program's queued work is waited
    for before a session closes, inside the window's time."""

    def __init__(self, torch, chunk_s: float = 2.0):
        self.torch, self.chunk_s = torch, float(chunk_s)
        self.prof = None
        self.opened = 0.0
        self.kernel_s = 0.0
        self.kernels = 0
        self.launches = 0
        self.sessions = 0

    def open(self) -> float:
        """Starts a session unless one is open; the seconds it took."""
        import time
        from torch.profiler import ProfilerActivity, profile
        if self.prof is not None:
            return 0.0
        a = time.perf_counter()
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(SPIN_KERNELS):
            self.torch.cuda._sleep(1000)
        self.torch.cuda.synchronize()
        self.opened = time.perf_counter()
        return self.opened - a

    def due(self) -> bool:
        import time
        return self.prof is not None and time.perf_counter() - self.opened >= self.chunk_s

    def close(self) -> float:
        """Waits for the card, ends the session and adds up its kernels;
        the seconds spent after the wait."""
        import time
        if self.prof is None:
            return 0.0
        self.torch.cuda.synchronize()
        a = time.perf_counter()
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        spans = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == self.torch.autograd.DeviceType.CUDA:
                if name and "spin" not in name and not name.startswith(("Memcpy", "Memset")):
                    s = _ns(e, "start")
                    spans.append((s, s + _ns(e, "dur")))
            elif name in _LAUNCH_CALLS:
                self.launches += 1
        self.launches -= SPIN_KERNELS
        self.kernels += len(spans)
        self.kernel_s += union_seconds(spans) * 1e-9
        self.sessions += 1
        return time.perf_counter() - a

    @property
    def records_lost(self) -> int:
        return max(self.launches - self.kernels, 0)
