"""One stereo camera through System.track_stereo: a rectified pair a frame
(synchronous mapping, the port's default System)."""

from __future__ import annotations


class Entry:
    def __init__(self, slam_config, n_cameras: int, device):
        from orb_slam_system_tpu_torch.config import Sensor
        from orb_slam_system_tpu_torch.models.system import System
        if n_cameras != 1:
            raise ValueError(f"system_stereo drives one camera, not {n_cameras}")
        self.systems = [System(slam_config, Sensor.STEREO, device=device)]

    def step(self, imgs, timestamp: float, right) -> list:
        """imgs, right u8[1, H, W]: the left and right views -> [Tcw or None]."""
        return [self.systems[0].track_stereo(imgs[0], right[0], timestamp)]
