"""One monocular camera through System.track_monocular (synchronous
mapping, the port's default System)."""

from __future__ import annotations


class Entry:
    def __init__(self, slam_config, n_cameras: int, device):
        from orb_slam_system_tpu_torch.config import Sensor
        from orb_slam_system_tpu_torch.models.system import System
        if n_cameras != 1:
            raise ValueError(f"system_mono drives one camera, not {n_cameras}")
        self.systems = [System(slam_config, Sensor.MONOCULAR, device=device)]

    def step(self, imgs, timestamp: float) -> list:
        """imgs u8[1, H, W] -> [Tcw or None]."""
        return [self.systems[0].track_monocular(imgs[0], timestamp)]
