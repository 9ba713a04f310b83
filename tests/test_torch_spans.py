"""The port's host spans (utils/metrics.py) on a few frames of the CPU
System: 320x240, 400 features, the textured-plane orbit of
drivers/mono_synthetic. Five frames run with no profiler, and with the
profiler range's constructor made to raise, so a span that entered the
profiler there would fail the run; two more run under torch.profiler (CPU
activity). Checked: the spans are CPU operations (not user annotations)
nested in system.frame, each telemetry record's `spans` has the
documented names and stays within the frame's track_ms + mapping_ms, and
the StageTimers' per-stage keys are unprefixed as before."""

import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              render_sequence)
from orb_slam_system_tpu_torch.models.system import System
from orb_slam_system_tpu_torch.utils import metrics

N_PLAIN, N_TRACED = 5, 2
NAME = re.compile(r"(system\.frame|(track|mapping|loop)\.[a-z0-9_]+)")
LAYERS = ("system.", "track.", "mapping.", "loop.")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine. Restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_range(name):
    raise AssertionError(f"span {name} entered the profiler with none active")


@pytest.fixture(scope="module")
def run():
    cfg = make_config(320, 240, 400)
    frames, _ = render_sequence(cfg, N_PLAIN + N_TRACED)
    slam = System(cfg, Sensor.MONOCULAR, device="cpu")
    metrics.take_spans()        # nothing earlier on this thread counts
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "_Range", _no_range)
        for i in range(N_PLAIN):
            slam.track_monocular(frames[i], i / 30.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(N_PLAIN, N_PLAIN + N_TRACED):
            slam.track_monocular(frames[i], i / 30.0)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(LAYERS)]
    return slam, events


def _interval(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def test_no_span_enters_the_profiler_without_one(run):
    slam, _ = run
    recs = slam.telemetry.records
    assert len(recs) == N_PLAIN + N_TRACED
    # The plain frames ran their spans (counted) with the range raising.
    for r in recs[:N_PLAIN]:
        assert r["spans"]["system.frame"][1] == 1
        assert r["spans"]["track.extract"][1] == 1


def test_spans_are_cpu_operations_in_the_trace(run):
    _, events = run
    names = {e.name() for e in events}
    assert {"system.frame", "track.extract", "track.pose_lm",
            "track.fetch"} <= names
    for e in events:
        assert NAME.fullmatch(e.name()), e.name()
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert e.activity_type() == "cpu_op", e.activity_type()
        assert not e.is_user_annotation()
    assert sum(e.name() == "system.frame" for e in events) == N_TRACED


def test_spans_nest_as_documented(run):
    _, events = run
    frames = [_interval(e) for e in events if e.name() == "system.frame"]
    fused = [_interval(e) for e in events if e.name() == "track.fused_device"]
    assert fused
    for e in events:
        s, t = _interval(e)
        # Every span of a synchronous frame lies in that frame's span.
        assert any(a <= s and t <= b for a, b in frames), e.name()
        if e.name() == "track.pose_lm":
            # The fused step's two LMs (the motion and local-map cores).
            assert any(a <= s and t <= b for a, b in fused)
    for a, b in fused:
        inside = sum(e.name() == "track.pose_lm" and a <= _interval(e)[0]
                     and _interval(e)[1] <= b for e in events)
        assert inside == 2


def test_records_carry_the_frame_spans(run):
    slam, events = run
    recs = slam.telemetry.records
    for r in recs:
        for name, (ms, calls) in r["spans"].items():
            assert NAME.fullmatch(name), name
            assert ms >= 0.0 and isinstance(calls, int) and calls >= 1
    # Tracked frames (after the first, which initializes) ran pose LMs and
    # waited on fetches; a keyframe's mapping ran its local BA.
    for r in recs[2:]:
        assert {"system.frame", "track.extract", "track.pose_lm",
                "track.fetch"} <= set(r["spans"])
    assert any("mapping.local_ba" in r["spans"] for r in recs)
    # The traced frames' records count what the trace shows.
    for name in ("track.pose_lm", "track.extract", "track.fetch"):
        assert sum(r["spans"].get(name, (0, 0))[1] for r in recs[N_PLAIN:]) \
            == sum(e.name() == name for e in events)


def test_frame_spans_stay_within_track_and_mapping(run):
    slam, _ = run
    for r in slam.telemetry.records:
        total = r["track_ms"] + r["mapping_ms"]
        sp = r["spans"]
        # system.frame is the one top-level span of a synchronous frame.
        assert sp["system.frame"][0] <= total + 1.0
        assert sp["system.frame"][0] >= total - 1.0
        # Disjoint children of it: frame build, the fused device step,
        # triangulation and local BA.
        parts = sum(sp.get(n, (0.0, 0))[0] for n in (
            "track.extract", "track.fused_device", "mapping.tri_fuse",
            "mapping.local_ba"))
        assert parts <= sp["system.frame"][0] + 1.0
        assert sp.get("track.pose_lm", (0.0, 0))[0] <= r["track_ms"] + 1.0
    rep = slam.timing_report()
    assert set(rep) == {"median_s", "mean_s"} and rep["median_s"] > 0


def test_stage_history_keys_are_unprefixed(run):
    slam, _ = run
    tr = slam.tracker.stage_ms.history
    mapper = slam.local_mapper.stage_ms.history
    assert {"fused_device", "bookkeeping", "kf_decision"} <= set(tr)
    assert {"tri_fuse", "local_ba", "ba_device", "process_new_kf"} <= set(mapper)
    for h in (tr, mapper, slam.loop_closer.stage_ms.history):
        assert not any("." in k for k in h)
    assert set(slam.tracker.stage_ms.ms) == set(tr)
    assert len(tr["fused_device"]) == sum(
        r["spans"].get("track.fused_device", (0, 0))[1]
        for r in slam.telemetry.records)
