"""The control: the references put in the program's place, one precision
lower than the configuration states (bfloat16 for float32), on the very
inputs a run checked. A sound limit passes the program and fails this.

  extraction: the frozen extractor run in bfloat16 on the sampled images;
  tracking:   the rendered poses rounded to bfloat16, at every frame the
              program returned a pose for;
  mapping:    the keyframes at their rendered poses, each map point where
              the ray of its first observation meets the ground, both
              rounded to bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import judge
from reference import geometry, orb


def _ground_point(Tcw: np.ndarray, K: np.ndarray, uv) -> np.ndarray:
    Rwc = Tcw[:3, :3].T
    C = -Rwc @ Tcw[:3, 3]
    d = Rwc @ np.linalg.solve(K, np.array([uv[0], uv[1], 1.0]))
    return C + (-C[2] / d[2]) * d


def numbers(samples, cameras, maps, cfg, K, device, fps, **_unused) -> dict:
    o = cfg["orb"]
    imgs = torch.as_tensor(np.stack([s[0] for s in samples])).to(device)
    low = orb.extract(imgs, int(o["n_features"]), float(o["scale_factor"]),
                      int(o["n_levels"]), int(o["ini_th_fast"]),
                      int(o["min_th_fast"]), dtype=torch.bfloat16)
    ctrl = [(img, judge.packed_from(low, b)) for b, (img, _p) in enumerate(samples)]
    out = {k: v for k, v in judge.extraction(ctrl, o, device).items()
           if k != "reference"}
    out.update(judge.tracking([
        (frames, [None if T is None else geometry.bf16(truth[i])
                  for i, T in zip(frames, poses)], truth)
        for frames, poses, truth in cameras]))
    low_maps = []
    for kfs, points, truth in maps:
        true_kfs, true_pts = [], {}
        for ts, _Tcw, uv, octave, mp_ids in kfs:
            T = truth[int(round(ts * fps))]
            true_kfs.append((ts, geometry.bf16(T), uv, octave, mp_ids))
            for a, m in enumerate(mp_ids):
                if m >= 0 and m in points and m not in true_pts:
                    true_pts[m] = geometry.bf16(_ground_point(T, K, uv[a]))
        low_maps.append((true_kfs, true_pts, truth))
    out.update(judge.mapping(low_maps, K, float(o["scale_factor"])))
    return out
