"""The port's endurance gate on the card (the counterpart of
tests/test_endurance.py, with its bars). Env-gated:

    ORB_SLAM_RUN_ENDURANCE=1 python -m pytest tests/test_torch_endurance.py \\
        -q -s -m cuda --noconftest

drivers/endurance_synthetic.run over ORB_SLAM_ENDURANCE_FRAMES frames
(1250 by default: 5 leaves of 250 frames, ~4.5 cm a frame, ~56 m) at
320x240: classic tracking, the pipelined mode with the synchronous mapper,
and the pipelined mode with the async mapper (one retry, as the JAX gate).
Bars: >= 90% tracked, a peak of >= 150 keyframes and no more at the end,
>= 2 loops, ATE < 12 cm, the last third's host-ms median within 2.5x the
first's; classic also the mapper's cull_kfs and process_new_kf first-20
against last-20 means; the pipelined modes >= 80% chain accepts, and the
async one no keyframe-wait timeout. The classic run prints its summary with
every global-BA solve's keyframes and solvers and the saved map's bytes
per keyframe as one JSON line.
"""

import json
import os

import pytest
import torch

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(os.environ.get("ORB_SLAM_RUN_ENDURANCE") != "1",
                       reason="long endurance run (set ORB_SLAM_RUN_ENDURANCE=1)")]

N = int(os.environ.get("ORB_SLAM_ENDURANCE_FRAMES", "1250"))


@pytest.fixture
def run():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from orb_slam_system_tpu_torch.drivers.endurance_synthetic import run
    return lambda **kw: run(n_frames=N, verbose=True,
                            leaves=max(N // 250, 1), device="cuda", **kw)


@pytest.fixture
def gba_solves(monkeypatch):
    """(keyframes C, solvers of its chunks) of every global-BA solve of the
    run, from spies on GBARunner._solve and local_ba's two solvers."""
    from orb_slam_system_tpu_torch.models import loop_closing
    from orb_slam_system_tpu_torch.solvers import local_ba
    chunks, solves = [], []
    for name in ("bundle_adjust", "bundle_adjust_cg"):
        def call(*a, _orig=getattr(local_ba, name), _name=name, **kw):
            if kw.get("n_iters") == loop_closing.GBARunner.CHUNK_ITERS:
                chunks.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(local_ba, name, call)
    orig_solve = loop_closing.GBARunner._solve

    def solve(runner, snapshot, cam):
        n0 = len(chunks)
        orig_solve(runner, snapshot, cam)
        solves.append((int(snapshot[0].Tcw.shape[0]),
                       sorted(set(chunks[n0:]))))
    monkeypatch.setattr(loop_closing.GBARunner, "_solve", solve)
    return solves


def report(slam, s, solves, tmp_path):
    """Print the run's summary with its global-BA solves, the saved map's
    bytes per keyframe and the card, as one JSON line."""
    path = str(tmp_path / "map.npz")
    slam.save_map(path)
    n_kf = slam.arena.n_keyframes()
    print(json.dumps({**s, "gba_solves": solves,
                      "gba_applied": slam.loop_closer.n_gba_applied,
                      "map_bytes": os.path.getsize(path),
                      "map_bytes_per_keyframe": os.path.getsize(path) / n_kf,
                      "card": torch.cuda.get_device_name(0)}))


def _thirds_ok(s):
    m1, _, m3 = s["host_ms_median_thirds"]
    return m3 <= 2.5 * max(m1, 1.0)


def test_endurance_1250_frames(run, gba_solves, tmp_path):
    slam, s = run()
    report(slam, s, gba_solves, tmp_path)
    assert s["n_tracked"] >= 0.9 * N, s
    assert s["n_keyframes_peak"] >= 150, s
    assert s["n_keyframes_final"] <= s["n_keyframes_peak"], s
    assert s["loops_closed"] >= 2, s
    assert s["ate_rmse_m"] < 0.12, s
    assert _thirds_ok(s), s
    for stage in ("cull_kfs", "process_new_kf"):
        a = s["stage_ms_first20_mean"].get(stage)
        b = s["stage_ms_last20_mean"].get(stage)
        if a is not None and b is not None and a > 1.0:
            assert b <= max(4.0 * a, 150.0), (stage, a, b, s)
    assert slam.tracker.epoch_violations == 0


def test_endurance_pipelined(run):
    slam, s = run(pipelined=True, async_mapping=False)
    assert s["n_tracked"] >= 0.9 * N, s
    assert s["n_keyframes_peak"] >= 150, s
    assert s["loops_closed"] >= 2, s
    assert s["ate_rmse_m"] < 0.12, s
    assert s["chain_stats"]["accept"] >= 0.8 * N, s
    assert _thirds_ok(s), s


def test_endurance_pipelined_async(run):
    def gates(s):
        return (s["n_tracked"] >= 0.9 * N and s["n_keyframes_peak"] >= 150
                and s["loops_closed"] >= 2 and s["ate_rmse_m"] < 0.12
                and s["chain_stats"]["accept"] >= 0.8 * N
                and s["kf_wait_stats"]["timeouts"] == 0 and _thirds_ok(s))

    for attempt in range(2):
        slam, s = run(pipelined=True, async_mapping=True)
        if gates(s):
            break
        print(f"attempt {attempt} below the gate: tracked={s['n_tracked']} "
              f"ate={s['ate_rmse_m']:.3f} loops={s['loops_closed']}")
    assert gates(s), s
