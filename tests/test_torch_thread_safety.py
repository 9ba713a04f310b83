"""The port's System under concurrent access (the counterpart of
tests/test_thread_safety.py), on the CPU: one thread tracks 14 frames of
the 320x240 orbit (300 features), a second calls the state getters and the
map's counts every millisecond, a third toggles localization mode. No
thread may raise, and every frame is recorded. (As in the JAX test, the
map itself is not a bar: at 300 features this scene does not initialize
in 14 frames, in either package's run here.)
"""

import threading
import time

import pytest
import torch

from orb_slam_system_tpu_torch.dataio.synthetic import (PlanarSceneRenderer,
                                                        make_texture,
                                                        orbit_trajectory)
from orb_slam_system_tpu_torch.drivers.mono_synthetic import make_config
from orb_slam_system_tpu_torch.models.system import System


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_concurrent_track_and_getters():
    cfg = make_config(n_features=300)
    r = PlanarSceneRenderer(cfg.camera.K, cfg.camera.width, cfg.camera.height,
                            texture=make_texture(1024, 8, 7), tex_scale=220.0)
    imgs = [r.render(T) for T in
            orbit_trajectory(14, radius=0.35, depth=-2.0, tilt=0.3)]
    slam = System(cfg, device="cpu")
    errors = []
    done = threading.Event()

    def reader():
        while not done.is_set():
            try:
                slam.get_tracking_state()
                slam.get_tracked_map_points()
                slam.get_tracked_keypoints_un()
                _ = slam.arena.n_keyframes(), slam.arena.n_points()
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errors.append(e)
                return
            time.sleep(0.001)

    def toggler():
        while not done.is_set():
            try:
                slam.activate_localization_mode()
                slam.deactivate_localization_mode()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return
            time.sleep(0.003)

    threads = [threading.Thread(target=reader), threading.Thread(target=toggler)]
    for t in threads:
        t.start()
    try:
        for i, img in enumerate(imgs):
            slam.track_monocular(img, i / 30.0)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=10)
        slam.shutdown()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert len(slam.telemetry.records) == len(imgs)
