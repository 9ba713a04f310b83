"""Structured metrics, stage timing, and profiling hooks.

Copy of orb_slam_system_tpu/utils/metrics.py (numpy-only) with the
profiler hook moved from jax.profiler to torch.profiler.

The reference's observability is std::cout lines + per-run timing printed by
the drivers (SURVEY.md §5). This subsystem upgrades that contract:
  * per-frame structured records (state, keypoints, matches, inliers, map
    sizes, per-stage milliseconds) emitted as JSON lines;
  * stage timers as context managers;
  * torch.profiler trace capture around a frame window for kernel-level
    inspection on the card.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional, TextIO


class StageTimer:
    """Accumulates wall-clock per named stage within a frame.

    History is bounded (deque per stage): an open-ended run (live camera,
    serving) must not grow memory per frame. 4096 entries cover the
    longest in-repo analysis window (the 1250-frame endurance gate reads
    first/last-third means per stage) while capping an hours-long live
    run at a few MB total.
    """

    HISTORY_CAP = 4096

    def __init__(self):
        self.ms: dict[str, float] = {}
        # Per-invocation history (one float per stage call) so growth of a
        # stage's cost with map size is measurable, not just the total.
        from collections import deque
        self._deque = deque
        self.history: dict[str, "deque[float]"] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1000.0
            self.ms[name] = self.ms.get(name, 0.0) + dt
            h = self.history.get(name)
            if h is None:
                h = self.history[name] = self._deque(
                    maxlen=self.HISTORY_CAP)
            h.append(dt)

    def reset(self):
        self.ms = {}
        self.history = {}


class Telemetry:
    """Per-frame metric records; optional JSONL sink (headless dashboards).

    Record keys follow the plan in SURVEY.md §5: n_keypoints, n_matches,
    n_inliers, state, ms/stage, map sizes.
    """

    def __init__(self, sink: Optional[TextIO] = None, jsonl_path: Optional[str] = None):
        self.records: list[dict] = []
        self._sink = sink
        self._file = open(jsonl_path, "w") if jsonl_path else None

    def emit(self, **fields):
        self.records.append(fields)
        if self._sink is not None or self._file is not None:
            line = json.dumps(fields, default=float)
            if self._sink is not None:
                self._sink.write(line + "\n")
            if self._file is not None:
                self._file.write(line + "\n")
                self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def summary(self) -> dict:
        """Median/mean of numeric fields across frames (the reference
        drivers' exit report, generalized)."""
        import numpy as np
        if not self.records:
            return {}
        out = {}
        keys = set()
        for r in self.records:
            keys.update(k for k, v in r.items() if isinstance(v, (int, float)))
        for k in sorted(keys):
            vals = np.asarray([r[k] for r in self.records if k in r], float)
            if len(vals):
                out[k] = {"median": float(np.median(vals)),
                          "mean": float(vals.mean())}
        return out


@contextlib.contextmanager
def profiler_trace(path: str):
    """Capture a torch.profiler trace (CPU + CUDA activity) around a code
    region and write it as a Chrome trace to `path` — kernel-level
    visibility for the hot path."""
    from torch.profiler import ProfilerActivity, profile
    import torch
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
