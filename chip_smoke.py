#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code != 0) when it fails:
  1. print the card's name and power limit (nvidia-smi) and torch's CUDA;
  2. build the three CUDA kernels from orb_slam_system_tpu_torch/csrc;
  3. hold each kernel against its plain PyTorch version on the card, at the
     slice's shapes (all 8 pyramid levels of a rendered 640x480 frame for
     kernel A, its 1024 keypoint slots for kernels B and C), and time both;
  4. run the slice at full width: a 30-frame 640x480 orbit over the
     textured plane (1000 features, 8 levels), map seeded from frame 0's
     depth at its true pose, frames 1-29 tracked through FrameBuilder.build
     and fused_track_step;
  5. check the result: frames accepted, pose error against ground truth,
     frame 0's features on the card against the port's CPU path, and that
     every kernel was launched by phase 4.
The second-to-last line is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 30
MIN_ACCEPTED = 27          # of the 29 tracked frames
# Tightened from 3 cm / 1 deg: this same run on the CPU and on the H100
# stays under 0.4 cm / 0.1 deg on this orbit.
MAX_POS_ERR_M = 0.01
MAX_ROT_ERR_DEG = 0.25
MAX_ANGLE_BIN_FLIPS = 0.01  # share of keypoints, card vs CPU extraction


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int = 20) -> float:
    """Mean device ms per call of fn over `reps` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pose_error(T, T_gt):
    """(camera-centre error in m, rotation error in degrees)."""
    C = -T[:3, :3].T @ T[:3, 3]
    C_gt = -T_gt[:3, :3].T @ T_gt[:3, 3]
    M = T[:3, :3] @ T_gt[:3, :3].T
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    ang = np.arctan2(0.5 * s, 0.5 * (np.trace(M) - 1.0))
    return float(np.linalg.norm(C - C_gt)), float(np.degrees(ang))


def profile_device(torch, label: str, fn, wall_ms: float) -> None:
    """Print how many device kernels one call of fn launches, their summed
    device time (torch.profiler), and the device's idle share against the
    unprofiled wall time wall_ms. A measurement only: if the profiler sees
    nothing here, say so and go on."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
        n = sum(e.count for e in evs)
        dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
        print(f"{label}: {n} device kernels, {dev_ms:.3f} ms summed device "
              f"time (profiler), wall {wall_ms:.3f} ms, device idle share "
              f"{1.0 - dev_ms / wall_ms:.3f}", flush=True)
    except Exception as e:  # noqa: BLE001 - an optional measurement
        print(f"{label}: device kernels not measured ({e})", flush=True)


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch does not import: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    try:
        from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig,
                                                      SlamConfig)
        from orb_slam_system_tpu_torch.dataio.synthetic import (
            PlanarSceneRenderer, make_texture, orbit_trajectory)
        from orb_slam_system_tpu_torch.models.frame import FrameBuilder
        from orb_slam_system_tpu_torch.models.track_device import TrackPrograms
        from orb_slam_system_tpu_torch.models.tracking import (
            LOCAL_MAP_SLOTS, fused_track_step, seed_map_from_depth)
        from orb_slam_system_tpu_torch.ops import brief, fast, patches
        from orb_slam_system_tpu_torch.ops.brief import _angle_bins
        from orb_slam_system_tpu_torch.ops.orientation import angles_from_moments
        from orb_slam_system_tpu_torch.ops.pyramid import build_pyramid
        from orb_slam_system_tpu_torch.utils import kernels
    except ImportError as e:
        fail(f"the port does not import (run from the repository root): {e}")
    if "jax" in sys.modules:
        fail("the port imported jax")

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)}", flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = kernels.build(verbose=True)
    kernels.library()
    print(f"built {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    W, H = 640, 480
    cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=1000))
    renderer = PlanarSceneRenderer(cam.K, W, H, texture=make_texture(2048, 8, 7),
                                   tex_scale=440.0)
    poses = orbit_trajectory(N_FRAMES, radius=0.35, depth=-2.0, tilt=0.3)
    frames = [np.clip(renderer.render(T), 0, 255).astype(np.uint8) for T in poses]
    fb = FrameBuilder(cfg, dev)
    ex = fb.extractor

    # 3. Each kernel against its plain version on the card.
    img = torch.from_numpy(frames[0]).to(dev).to(torch.float32)[None]
    levels = build_pyramid(img, cfg.orb.n_levels, cfg.orb.scale_factor)
    report = {}
    errs_a = []
    for lvl in levels:
        k_out = fast.fast_score_nms(lvl, 19)
        p_out = fast.nms3x3(fast.fast_score_map(lvl, 19))
        if not torch.equal(k_out, p_out):
            n_bad = int((k_out != p_out).sum())
            fail(f"kernel A differs from the plain version on level "
                 f"{tuple(lvl.shape)}: {n_bad} pixels")
        errs_a.append(float((k_out - p_out).abs().max()))
    ms_a = cuda_ms(torch, lambda: [fast.fast_score_nms(l, 19) for l in levels])
    plain_a = cuda_ms(torch, lambda: [fast.nms3x3(fast.fast_score_map(l, 19))
                                      for l in levels])
    report["fast_score_nms"] = dict(
        source="orb_slam_system_tpu_torch/csrc/fast_score_nms.cu",
        replaces="orb_slam_system_tpu/ops/fast_pallas.py:108",
        max_abs_err=max(errs_a), ms=ms_a, plain_ms=plain_a)
    print(f"kernel A fast_score_nms: bit-exact on {len(levels)} levels "
          f"{[tuple(l.shape[1:]) for l in levels]}; {ms_a:.4f} ms "
          f"(plain {plain_a:.4f} ms) per frame, {card}", flush=True)

    _, canvas, xy_all = ex.detect(img)
    kb, km = patches.gather_blur_moments(canvas, xy_all, 21)
    pb, pm = patches.gather_blur_moments_plain(canvas, xy_all, 21)
    if not torch.equal(kb, pb):
        fail(f"kernel B blur differs: {int((kb != pb).sum())} values, max "
             f"{float((kb - pb).abs().max())}")
    mom_err = float((km - pm).abs().max())
    if not mom_err <= 0.5:
        fail(f"kernel B moments differ by {mom_err} (> 0.5)")
    ms_b = cuda_ms(torch, lambda: patches.gather_blur_moments(canvas, xy_all, 21))
    plain_b = cuda_ms(torch, lambda: patches.gather_blur_moments_plain(
        canvas, xy_all, 21))
    report["gather_blur_moments"] = dict(
        source="orb_slam_system_tpu_torch/csrc/gather_blur_moments.cu",
        replaces="orb_slam_system_tpu/ops/gather_pallas.py:336",
        max_abs_err=mom_err, ms=ms_b, plain_ms=plain_b)
    n_bins_b = int((_angle_bins(angles_from_moments(km))
                    != _angle_bins(angles_from_moments(pm))).sum())
    print(f"kernel B gather_blur_moments: canvas {tuple(canvas.shape)}, "
          f"{xy_all.shape[1]} keypoints; blur bit-exact, moments max err "
          f"{mom_err:.3g}, angle-bin flips {n_bins_b}; {ms_b:.4f} ms "
          f"(plain {plain_b:.4f} ms), {card}", flush=True)

    ang = angles_from_moments(pm)
    kc = brief.brief_pack(pb, ang)
    pc = brief.brief_pack_plain(pb, ang)
    if not torch.equal(kc, pc):
        fail(f"kernel C differs in {int((kc != pc).any(-1).sum())} keypoints")
    ms_c = cuda_ms(torch, lambda: brief.brief_pack(pb, ang))
    plain_c = cuda_ms(torch, lambda: brief.brief_pack_plain(pb, ang))
    report["brief_pack"] = dict(
        source="orb_slam_system_tpu_torch/csrc/brief_pack.cu",
        replaces="orb_slam_system_tpu/ops/brief_pallas.py:68",
        max_abs_err=0.0, ms=ms_c, plain_ms=plain_c)
    print(f"kernel C brief_pack: {tuple(kc.shape)} words bit-exact; "
          f"{ms_c:.4f} ms (plain {plain_c:.4f} ms), {card}", flush=True)

    # 4. The slice at full width; the counters count only this phase.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    programs = TrackPrograms(cfg, ex.n_slots, LOCAL_MAP_SLOTS, fb.bounds, dev)
    f0 = fb.build(frames[0], 0.0)
    T0 = poses[0].astype(np.float32)
    local_map, mp_ids = seed_map_from_depth(
        f0.feats, T0, renderer.render_depth(poses[0]), cam, fb.scale_factors)
    last, last_T, last_ids = f0, T0, mp_ids
    velocity = np.eye(4, dtype=np.float32)
    ms_extract, ms_track, errors, accepted = [], [], [], 0
    for i in range(1, N_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur = fb.build(frames[i], i / 30.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fused_track_step(programs, last.packed, cur.packed, last_T,
                               last_ids, velocity, local_map, cam)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ms_extract.append(1e3 * (t1 - t0))
        ms_track.append(1e3 * (t2 - t1))
        if res is None:
            print(f"frame {i}: rejected by the fused gates", flush=True)
            continue
        accepted += 1
        e_pos, e_rot = pose_error(res.Tcw.astype(np.float64), poses[i])
        errors.append((e_pos, e_rot))
        print(f"frame {i}: matched {res.n_matched} inliers {res.n_in1}/"
              f"{res.n_in2} pose error {100 * e_pos:.3f} cm {e_rot:.4f} deg "
              f"extract {ms_extract[-1]:.2f} ms track {ms_track[-1]:.2f} ms",
              flush=True)
        velocity = (res.Tcw @ np.linalg.inv(last_T)).astype(np.float32)
        last, last_T, last_ids = cur, res.Tcw, res.mp_ids
    launches = dict(kernels.LAUNCHES)
    med_e, med_t = statistics.median(ms_extract), statistics.median(ms_track)
    print(f"slice: {accepted}/{N_FRAMES - 1} frames accepted; ms per frame "
          f"over {len(ms_track)} frames (host clock around "
          f"torch.cuda.synchronize): extraction median {med_e:.3f} max "
          f"{max(ms_extract):.3f}, fused step median {med_t:.3f} max "
          f"{max(ms_track):.3f} (frame 1 includes first-call set-up), {card}",
          flush=True)

    # 5. Checks.
    if accepted < MIN_ACCEPTED:
        fail(f"only {accepted} of {N_FRAMES - 1} frames accepted "
             f"(need {MIN_ACCEPTED})")
    worst_pos = max(e[0] for e in errors)
    worst_rot = max(e[1] for e in errors)
    print(f"worst pose error: {100 * worst_pos:.3f} cm, {worst_rot:.4f} deg",
          flush=True)
    if worst_pos >= MAX_POS_ERR_M or worst_rot >= MAX_ROT_ERR_DEG:
        fail(f"pose error above {100 * MAX_POS_ERR_M:g} cm / "
             f"{MAX_ROT_ERR_DEG:g} deg")
    packed = f0.packed
    if tuple(packed.shape) != (ex.n_slots, 16) or not bool(
            torch.isfinite(packed[:, :8]).all()):
        fail(f"frame 0 packed output malformed: {tuple(packed.shape)}")
    ref = FrameBuilder(cfg, "cpu").extract_packed(frames[0])
    got = packed.cpu()
    if not torch.equal(got[:, [0, 1, 4, 6, 7]], ref[:, [0, 1, 4, 6, 7]]):
        fail("frame 0 keypoints on the card differ from the CPU path")
    flips = (_angle_bins(got[:, 5]) != _angle_bins(ref[:, 5]))
    desc_diff = (got[:, 8:16].view(torch.int32)
                 != ref[:, 8:16].view(torch.int32)).any(dim=1)
    if bool((desc_diff & ~flips).any()):
        fail("descriptor bits differ from the CPU path beyond angle-bin flips")
    if int(flips.sum()) > MAX_ANGLE_BIN_FLIPS * ex.n_slots:
        fail(f"{int(flips.sum())} angle-bin flips against the CPU path")
    print(f"frame 0 vs the CPU path: keypoints identical, {int(flips.sum())} "
          f"angle-bin flips, descriptors equal elsewhere", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the slice")
    print(f"launches in the slice: {launches}", flush=True)

    # Where the time goes: kernels launched, device time, idle share.
    f1 = fb.build(frames[1], 0.0)
    eye = np.eye(4, dtype=np.float32)
    profile_device(torch, "one frame build (extraction)",
                   lambda: fb.build(frames[1], 0.0), med_e)
    profile_device(torch, "one fused step", lambda: fused_track_step(
        programs, f0.packed, f1.packed, T0, mp_ids, eye, local_map, cam),
        med_t)
    Xw = torch.from_numpy(local_map.pos[np.maximum(mp_ids, 0)]).to(dev)
    Tcw = torch.from_numpy(T0).to(dev)
    obs = f0.packed[:, 2:4].contiguous()
    inv_s2 = torch.ones(ex.n_slots, device=dev)
    ok = torch.from_numpy(mp_ids >= 0).to(dev)
    mono = torch.full((ex.n_slots,), -1.0, device=dev)
    lm = lambda: programs._pose_opt(Tcw, Xw, obs, inv_s2, ok, mono)
    lm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm()
    torch.cuda.synchronize()
    profile_device(torch, "one pose optimization (4x10 LM, 1024 edges)", lm,
                   1e3 * (time.perf_counter() - t0))

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]} for name, r in report.items()]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
