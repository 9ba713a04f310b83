"""Helpers of the benchmark's CPU tests: a checkout-like root in a temporary
directory, holding a copy of the benchmark folder, a BENCHMARK.json and the
program, with a tiny configuration and traffic mix added as new files
(monocular, or a stereo or RGB-D rig)."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


MULTISYSTEM_ENTRY = '''
class Entry:
    """S monocular cameras through MultiSystem.track_batch."""

    def __init__(self, slam_config, n_cameras, device):
        from orb_slam_system_tpu_torch.parallel.multi_system import MultiSystem
        self.multi = MultiSystem(slam_config, n_cameras, device=device)
        self.systems = self.multi.systems

    def step(self, imgs, timestamp):
        return self.multi.track_batch(imgs, timestamp)
'''


# The tiny rigs (320x240 at KITTI's 10 fps): a rectified stereo pair whose
# 90 px * m of bf gives 37-49 px of disparity on the ground 1.8-2.4 m away,
# KITTI's ThDepth; an RGB-D camera with TUM1's distortion, TUM2's ThDepth and
# DepthMapFactor and its bf at half the focal length. A depth-seeded map
# takes a keyframe only once a quarter of its reference keyframe's points
# are lost, so the rigs' mix moves 12 px a frame, not 3, and set-up reaches
# five keyframes in some 40-70 frames. A depth-seeded map reprojects well
# without local BA, so each rig's map_chi2_p95 limit lies between its own
# readings on the CPU over 4-5 seeds: sound runs 0.29-0.42 (stereo) and
# 0.10-0.14 (RGB-D), local BA skipped 1.39-2.02 and 0.50-0.54.
RIGS = {
    "stereo": {"entry": "system_stereo", "bf": 90.0, "th_depth": 35.0,
               "rectified": True, "map_chi2_p95": 0.8},
    "rgbd": {"entry": "system_rgbd", "bf": 20.0, "th_depth": 40.0,
             "depth_map_factor": 5208.0, "rectified": False, "map_chi2_p95": 0.25},
}


def make_root(tmp, n_cameras: int = 1, sensor: str = "monocular") -> str:
    """A root with the benchmark copied, plus the cell tiny_mono.tiny_explore
    (tiny_x2.tiny_explore for two cameras, tiny_stereo.tiny_explore or
    tiny_rgbd.tiny_explore for a rig): 320x240, 400 features, four levels,
    the explore mix over fewer frames."""
    root = str(tmp)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "orb_slam_system_tpu_torch"),
               os.path.join(root, "orb_slam_system_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "tum1_mono.json")) as f:
        cfg = json.load(f)
    name = "tiny_mono" if n_cameras == 1 else f"tiny_x{n_cameras}"
    entry = "system_mono"
    if sensor != "monocular":
        name, entry = f"tiny_{sensor}", RIGS[sensor]["entry"]
    if n_cameras > 1:
        # A batched entry added as a new file, as a later cell would add it.
        entry = "tiny_multisystem_mono"
        with open(os.path.join(b, "entries", entry + ".py"), "w") as f:
            f.write(MULTISYSTEM_ENTRY)
    cfg.update(name=name, cameras=n_cameras, entry=entry)
    cfg["camera"].update(fx=258.65, fy=258.23, cx=159.3, cy=127.6,
                         width=320, height=240)
    cfg["orb"].update(n_features=400, n_levels=4)
    if sensor != "monocular":
        rig = RIGS[sensor]
        cfg.update(sensor=sensor, th_depth=rig["th_depth"])
        cfg["camera"].update(bf=rig["bf"], fps=10.0)
        if "depth_map_factor" in rig:
            cfg["depth_map_factor"] = rig["depth_map_factor"]
        if rig["rectified"]:
            cfg["camera"].update(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    with open(os.path.join(b, "configs", name + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "explore.json")) as f:
        traffic = json.load(f)
    traffic.update(spare_frames=60, check_frames=3)
    traffic["warm"]["max_setup_frames"] = 80
    if sensor != "monocular":
        traffic["speed_px"] = 12.0
        traffic["warm"]["max_setup_frames"] = 100
    with open(os.path.join(b, "traffic", "tiny_explore.json"), "w") as f:
        json.dump(traffic, f)
    workload = f"{name}.tiny_explore"
    with open(os.path.join(b, "limits", "tum1_mono.explore.json")) as f:
        limits = json.load(f)
    if sensor != "monocular":
        limits["compare"]["map_chi2_p95"]["limit"] = RIGS[sensor]["map_chi2_p95"]
    with open(os.path.join(b, "limits", workload + ".json"), "w") as f:
        json.dump(limits, f)
    bench["configs"].append(dict(bench["configs"][0], name=name,
                                 file=f"benchmark/configs/{name}.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=workload,
                                   config=name, traffic="tiny_explore"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_tiny(root: str, workload: str, seed: int = 3000000001, seconds: int = 6,
             **kw) -> dict:
    import torch
    from harness import cell
    torch.set_num_threads(2)
    return cell.run(root, workload, seed, seconds, False, device="cpu", **kw)
