"""Per-frame telemetry and the port's host spans.

A span is a named stretch of host time, `<layer>.<stage>` (`system.frame`,
`track.extract`, `track.pose_lm`, `mapping.local_ba`, `loop.detect_loop`,
...). Each span

  * while a torch profiler is active, opens a host-only range of its name
    on the profiler's timeline: a CPU operation (`cpu_op`), which gets no
    device-side record, so the trace places the span on the device's clock
    without counting it as device work;
  * adds its inclusive host ms and one call to this thread's per-frame
    account, which System takes into each frame's telemetry record
    (`spans`: {name: [ms, calls]}, every span since the thread's last
    record).

No span synchronizes the device, records a CUDA event or reads anything
back: the device's side of a span comes from the trace. With no profiler
active a span costs a flag check, two clock reads and a dict update.
`fetch` is the one blocking device->host copy of the tracking, mapping and
loop-closing paths, a span of its own (`<layer>.fetch`), so the time the
host waits for the card is told apart from its own work.

StageTimer gives a layer's named stages their spans and keeps, per stage,
its total ms and a bounded per-call history.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch
from torch.autograd import profiler as _profiler

# A host-only profiler range (a cpu_op event). torch.profiler.record_function
# is not used: its user annotation gets a device-side copy under CUDA
# activity, which the trace would count as a device operation.
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_local = threading.local()


def _account() -> dict:
    try:
        return _local.spans
    except AttributeError:
        _local.spans = acc = {}
        return acc


def take_spans() -> dict:
    """This thread's spans since its last take, {name: [ms, calls]}; the
    account starts again empty."""
    acc = _account()
    _local.spans = {}
    return acc


class _Span:
    """One span (module docstring); `timer` also gets its stage's ms."""

    __slots__ = ("_name", "_timer", "_stage", "_range", "_t0")

    def __init__(self, name: str, timer=None, stage=None):
        self._name = name
        self._timer = timer
        self._stage = stage

    def __enter__(self):
        if _profiler._is_profiler_enabled and _Range is not None:
            self._range = _Range(self._name)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1e3
        if self._range is not None:
            self._range.__exit__(*exc)
        acc = _account()
        entry = acc.get(self._name)
        if entry is None:
            acc[self._name] = [ms, 1]
        else:
            entry[0] += ms
            entry[1] += 1
        if self._timer is not None:
            self._timer._add(self._stage, ms)
        return False


def span(name: str) -> _Span:
    """A span for code with no StageTimer of its own (the frame builder,
    the tracking programs); `name` is the full `<layer>.<stage>`."""
    return _Span(name)


_FETCH = {}


def fetch(t: torch.Tensor, layer: str) -> np.ndarray:
    """t copied to the host as numpy, inside the span `<layer>.fetch`: the
    copy waits for the work queued before it."""
    name = _FETCH.get(layer)
    if name is None:
        name = _FETCH[layer] = layer + ".fetch"
    with _Span(name):
        return t.cpu().numpy()


class StageTimer:
    """The named stages of one layer (`prefix`: "track", "mapping",
    "loop"): stage(name) is the span `<prefix>.<name>`, and adds to the
    stage's total ms and per-call history (unprefixed keys).

    History is bounded (deque per stage): an open-ended run (live camera,
    serving) must not grow memory per frame. 4096 entries cover the
    longest in-repo analysis window (the 1250-frame endurance gate reads
    first/last-third means per stage) while capping an hours-long live
    run at a few MB total.
    """

    HISTORY_CAP = 4096

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._names: dict[str, str] = {}
        self.ms: dict[str, float] = {}
        # Per-invocation history (one float per stage call) so growth of a
        # stage's cost with map size is measurable, not just the total.
        self.history: dict[str, deque] = {}

    def stage(self, name: str) -> _Span:
        full = self._names.get(name)
        if full is None:
            full = self._names[name] = f"{self.prefix}.{name}"
        return _Span(full, self, name)

    def _add(self, name: str, ms: float):
        self.ms[name] = self.ms.get(name, 0.0) + ms
        h = self.history.get(name)
        if h is None:
            h = self.history[name] = deque(maxlen=self.HISTORY_CAP)
        h.append(ms)

    def reset(self):
        self.ms = {}
        self.history = {}


class Telemetry:
    """Per-frame metric records, kept in memory (System._record): state,
    keypoints, inliers, map sizes, track_ms, mapping_ms and the frame's
    spans."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, **fields):
        self.records.append(fields)
