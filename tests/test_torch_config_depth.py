"""ThDepth from a settings file, in metres.

The reference reads ThDepth in units of the stereo baseline for the stereo
and RGB-D sensors (its Tracking constructor sets mThDepth = bf * ThDepth /
fx); the port's load_settings converts it, so SlamConfig.th_depth is in
metres, the unit the tracker compares depths in. The JAX package stores the
file's number raw (35 m for KITTI 00-02, 40 m for TUM1). Tolerance: 0.01 m
against the hand-computed values, exact round trips.
"""

import dataclasses
import os

import pytest

from orb_slam_system_tpu_torch.config import (Sensor, load_settings,
                                              save_settings_yaml)

SETTINGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "settings")


@pytest.mark.parametrize("name,sensor,metres", [
    ("kitti00-02.yaml", Sensor.STEREO, 386.1448 * 35.0 / 718.856),   # 18.80
    ("tum1.yaml", Sensor.RGBD, 40.0 * 40.0 / 517.306408),            # 3.09
])
def test_th_depth_in_metres(name, sensor, metres):
    cfg = load_settings(os.path.join(SETTINGS, name), sensor)
    assert cfg.th_depth == pytest.approx(metres, abs=1e-6)
    assert cfg.th_depth == pytest.approx({"kitti00-02.yaml": 18.80,
                                          "tum1.yaml": 3.09}[name], abs=0.01)


def test_monocular_load_unchanged():
    cfg = load_settings(os.path.join(SETTINGS, "tum1.yaml"), Sensor.MONOCULAR)
    assert cfg.th_depth == 40.0


@pytest.mark.parametrize("name,sensor", [("kitti00-02.yaml", Sensor.STEREO),
                                         ("tum1.yaml", Sensor.RGBD),
                                         ("tum1.yaml", Sensor.MONOCULAR)])
def test_settings_round_trip(tmp_path, name, sensor):
    """save_settings_yaml writes ThDepth back in the file's unit, so a
    load -> save -> load gives the same config and the file's number."""
    cfg = load_settings(os.path.join(SETTINGS, name), sensor)
    path = str(tmp_path / "settings.yaml")
    save_settings_yaml(cfg, path)
    again = load_settings(path, sensor)
    assert again.th_depth == pytest.approx(cfg.th_depth, rel=1e-12)
    assert dataclasses.replace(again, th_depth=cfg.th_depth) == cfg
    written = [ln for ln in open(path) if ln.startswith("ThDepth:")]
    assert float(written[0].split(":")[1]) == pytest.approx(
        {"kitti00-02.yaml": 35.0, "tum1.yaml": 40.0}[name], rel=1e-12)
