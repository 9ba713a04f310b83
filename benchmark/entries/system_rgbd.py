"""One RGB-D camera through System.track_rgbd (synchronous mapping, the
port's default System)."""

from __future__ import annotations


class Entry:
    def __init__(self, slam_config, n_cameras: int, device):
        from orb_slam_system_tpu_torch.config import Sensor
        from orb_slam_system_tpu_torch.models.system import System
        if n_cameras != 1:
            raise ValueError(f"system_rgbd drives one camera, not {n_cameras}")
        self.systems = [System(slam_config, Sensor.RGBD, device=device)]

    def step(self, imgs, timestamp: float, depth) -> list:
        """imgs u8[1, H, W] the colour view, depth u16[1, H, W] its registered
        raw depth in DepthMapFactor units (z * DepthMapFactor, 0 for none),
        as TUM's depth PNGs hand it in -> [Tcw or None]."""
        return [self.systems[0].track_rgbd(imgs[0], depth[0], timestamp)]
