"""Rigs of one camera with a second view or a depth image, driven through a
whole run at a size a test run holds (the CPU, 320x240, 400 features): a
stereo and an RGB-D configuration added as new files run correct and hold
metric scale; the control and the faults planted underneath the harness
(which patch System._track and LocalMapper.local_ba, the same under every
sensor) fail them. A monocular configuration builds the SlamConfig it always
built."""

import pytest

import bench_support
from harness import cell, control, faults, judge
from harness.registry import Registry

SENSORS = ("stereo", "rgbd")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {s: bench_support.make_root(tmp_path_factory.mktemp(s), sensor=s)
            for s in SENSORS}


@pytest.mark.parametrize("sensor", SENSORS)
def test_rig_run_is_correct_and_its_control_is_not(roots, sensor):
    workload = f"tiny_{sensor}.tiny_explore"
    got = {}
    r = bench_support.run_tiny(roots[sensor], workload, on_check=lambda **kw: got.update(
        program=dict(kw["numbers"]), control=control.numbers(**kw)))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert got["program"]["scale_err_pct"] < 5.0, got["program"]
    ok, checks = judge.verdict(got["control"], Registry(roots[sensor]).limits(workload))
    assert not ok, checks


@pytest.mark.parametrize("fault", ["pose_unchanged", "pose_dropped", "local_ba_skipped"])
@pytest.mark.parametrize("sensor", SENSORS)
def test_rig_fault_fails(roots, sensor, fault, monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    r = bench_support.run_tiny(roots[sensor], f"tiny_{sensor}.tiny_explore")
    assert not r["correct"], r["checks"]
    if fault == "pose_dropped":
        assert r["failed"] > 0


def test_monocular_slam_config_is_unchanged():
    from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig, Sensor,
                                                  SlamConfig)
    cfg = Registry(bench_support.REPO).config("tum1_mono")
    cam = cfg["camera"]
    # What the harness built before configurations named their sensor.
    before = SlamConfig(
        camera=CameraConfig(**{k: cam[k] for k in (
            "fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "fps", "width",
            "height")}),
        orb=ORBConfig(**cfg["orb"]), sensor=Sensor.MONOCULAR)
    assert cell.slam_config(cfg) == before


@pytest.mark.parametrize("sensor", SENSORS)
def test_rig_slam_config_takes_the_settings_numbers(roots, sensor):
    from orb_slam_system_tpu_torch.config import Sensor
    cfg = Registry(roots[sensor]).config(f"tiny_{sensor}")
    sc = cell.slam_config(cfg)
    rig = bench_support.RIGS[sensor]
    assert sc.sensor == Sensor[sensor.upper()]
    assert sc.camera.bf == rig["bf"]
    # ThDepth in units of the baseline, as a settings file gives it.
    assert sc.th_depth == pytest.approx(rig["bf"] * rig["th_depth"] / sc.camera.fx)
    assert sc.depth_map_factor == rig.get("depth_map_factor", 1.0)


def test_a_rig_configuration_is_refused_where_it_lacks_what_it_needs():
    from harness import scene
    cfg = Registry(bench_support.REPO).config("tum1_mono")
    with pytest.raises(ValueError, match="rectified"):
        scene.sensor_of(dict(cfg, sensor="stereo",
                             camera=dict(cfg["camera"], bf=40.0)))
    with pytest.raises(ValueError, match="bf"):
        scene.sensor_of(dict(cfg, sensor="rgbd", depth_map_factor=5000.0))
    with pytest.raises(ValueError, match="depth_map_factor"):
        scene.sensor_of(dict(cfg, sensor="rgbd", camera=dict(cfg["camera"], bf=40.0)))
    with pytest.raises(ValueError, match="none of"):
        scene.sensor_of(dict(cfg, sensor="fisheye"))
    assert scene.sensor_of(cfg) == "monocular"
