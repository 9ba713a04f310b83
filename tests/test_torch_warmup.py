"""The port's warm pass on the CPU (utils/warmup.py, System(prewarm=...),
drivers/warm_cache.py; the JAX package's utils/warmup.py and
tools/warm_cache.py).

Criteria: warm(cfg) runs both modes at cfg's 320x240 camera (not the JAX
pass's fixed 640x480) and returns their seconds; a System made inside the
pass with prewarm=True does not start a second pass (the re-entrancy
guard); System(prewarm=True) returns poses bit-equal to
System(prewarm=False) on the same frames; warm_cache's command line runs
the pass and reports it.
"""

import numpy as np
import pytest
import torch

import orb_slam_system_tpu_torch.models.system as system_mod
from orb_slam_system_tpu_torch.config import Sensor
from orb_slam_system_tpu_torch.drivers import mono_synthetic, warm_cache
from orb_slam_system_tpu_torch.utils import warmup

N_FEATURES = 400


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module, as the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return mono_synthetic.make_config(n_features=N_FEATURES)


def test_warm_runs_at_the_config_and_reenters_without_recursing(cfg,
                                                                monkeypatch):
    made, renders = [], []
    real_render = warmup.PlanarSceneRenderer.render

    class Nested(system_mod.System):
        def __init__(self, *a, **kw):
            kw["prewarm"] = True          # would recurse without the guard
            super().__init__(*a, **kw)
            made.append(self)

    def render(self, T):
        renders.append((self.width, self.height))
        return real_render(self, T)
    monkeypatch.setattr(system_mod, "System", Nested)
    monkeypatch.setattr(warmup.PlanarSceneRenderer, "render", render)
    seconds = warmup.warm(cfg, n_frames=4, verbose=False, device="cpu")
    assert list(seconds) == [m for m, _, _ in warmup.MODES]
    assert all(s > 0 for s in seconds.values())
    assert len(made) == 2 and all(s.warm_seconds == {} for s in made)
    assert [s.async_mapping for s in made] == [False, True]
    assert renders == [(320, 240)] * 4
    assert not warmup._WARMING


def test_prewarmed_system_tracks_bit_equal(cfg, monkeypatch):
    monkeypatch.setattr(warmup, "PREWARM_FRAMES", 4)
    frames, _ = mono_synthetic.render_sequence(cfg, 8)
    poses = []
    for prewarm in (False, True):
        slam = system_mod.System(cfg, Sensor.MONOCULAR, device="cpu",
                                 prewarm=prewarm)
        assert bool(slam.warm_seconds) == prewarm
        poses.append([slam.track_monocular(f, i / 30.0)
                      for i, f in enumerate(frames)])
        slam.shutdown()
    assert sum(T is not None for T in poses[0]) >= 6
    for a, b in zip(*poses):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)


def test_warm_cache_command_line(capsys):
    assert warm_cache.main(["2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for mode, _, _ in warmup.MODES:
        assert f"# warmed {mode}: 2 frames at 640x480" in out
    assert "# built libraries:" in out
