#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code != 0) when it fails:
  1. print the card's name and power limit (nvidia-smi) and torch's CUDA;
  2. build the four CUDA kernels from orb_slam_system_tpu_torch/csrc (one
     nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version on the card, at the
     slice's shapes (all 8 pyramid levels of a rendered 640x480 frame for
     kernel A, its 1024 keypoint slots for kernels B, C and D), and time
     the kernel, its plain version and, where one PyTorch call computes
     the same function, that call (torch.gather for kernel D); then run
     the extractor's unfused route (kernel D) over 10 frames, with the
     launch counts read around it, and hold frame 0 against the fused
     route;
  4. run the first slice at full width: a 30-frame 640x480 orbit over the
     textured plane (1000 features, 8 levels), map seeded from frame 0's
     depth at its true pose, frames 1-29 tracked through FrameBuilder.build
     and fused_track_step; check frames accepted, pose error against
     ground truth, and frame 0's features on the card against the port's
     CPU path;
  5. run the System (the main path): System.track_monocular over a
     60-frame 640x480 orbit through drivers/mono_synthetic.run: two-view
     initialization on the 2048-slot builder, keyframes, local mapping;
     print per-frame and
     per-stage times, a profiler count of one keyframe insertion and one
     local BA, and check the reference's bars (state OK, >= 3 keyframes,
     > 150 map points, ATE < 3 cm) plus >= 90% of the frames after
     initialization tracked, and that every kernel of the path launched.
The second-to-last line is a JSON object with each kernel's launches, error,
times and bound; the last line is {"ok": true, "device": {...}}. Without
CUDA, or without the package beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FRAMES = 30
MIN_ACCEPTED = 27          # of the 29 tracked frames
# Tightened from 3 cm / 1 deg: this same run on the CPU and on the H100
# stays under 0.4 cm / 0.1 deg on this orbit.
MAX_POS_ERR_M = 0.01
MAX_ROT_ERR_DEG = 0.25
MAX_ANGLE_BIN_FLIPS = 0.01  # share of keypoints, card vs CPU extraction
N_UNFUSED_FRAMES = 10
SYSTEM_FRAMES = 60
MIN_TRACKED_SHARE = 0.9     # of the System's frames after initialization
MAX_ATE_M = 0.03            # tests/test_e2e_mono.py bar
# H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_ms(n_bytes: float, n_ops: float):
    """Least time the card could take: (ms, "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


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


def profile_device(torch, label: str, fn, wall_ms) -> None:
    """Print how many device kernels one call of fn launches, their summed
    device time (torch.profiler), and the device's idle share against the
    unprofiled wall time wall_ms (None: the host-clock time of the profiled
    call itself, which the profiler inflates). A measurement only: if the
    profiler sees nothing here, say so and go on."""
    from torch.profiler import ProfilerActivity, profile
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if wall_ms is None:
            wall_ms = 1e3 * (time.perf_counter() - t0)
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
                                                      SlamConfig, TrackingState)
        from orb_slam_system_tpu_torch.drivers import mono_synthetic
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
    # Each level read and written once; per pixel 16 differences, ~300
    # min/max of the segment test and 9 NMS max (csrc/fast_score_nms.cu).
    px = sum(l.numel() for l in levels)
    report["fast_score_nms"] = dict(
        source="orb_slam_system_tpu_torch/csrc/fast_score_nms.cu",
        replaces="orb_slam_system_tpu/ops/fast_pallas.py:108",
        max_abs_err=max(errs_a), ms=ms_a, plain_ms=plain_a,
        bound=bound_ms(8.0 * px, 330.0 * px), library_ms=None)
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
    n_kp = xy_all.shape[1]
    pb_side = kb.shape[-1]
    report["gather_blur_moments"] = dict(
        source="orb_slam_system_tpu_torch/csrc/gather_blur_moments.cu",
        replaces="orb_slam_system_tpu/ops/gather_pallas.py:336",
        max_abs_err=mom_err, ms=ms_b, plain_ms=plain_b,
        # Canvas and centres read once, blurred patches and moments
        # written once; row + column blur passes and the moments.
        bound=bound_ms(4.0 * (canvas.numel() + xy_all.numel() + kb.numel()
                              + km.numel()),
                       n_kp * (2 * 7 * pb_side * 43 + 2 * 7 * pb_side ** 2
                               + 4 * 31 * 31)),
        library_ms=None)
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
        max_abs_err=0.0, ms=ms_c, plain_ms=plain_c,
        # Blurred patches and angles read once, words written once; two
        # bf16 roundings and one compare per test.
        bound=bound_ms(4.0 * (pb.numel() + ang.numel() + kc.numel()),
                       3.0 * 256 * n_kp),
        library_ms=None)
    print(f"kernel C brief_pack: {tuple(kc.shape)} words bit-exact; "
          f"{ms_c:.4f} ms (plain {plain_c:.4f} ms), {card}", flush=True)

    kd = patches.gather_patches(canvas, xy_all, 21)
    pd = patches.gather_patches_plain(canvas, xy_all, 21)
    if not torch.equal(kd, pd):
        fail(f"kernel D differs in {int((kd != pd).sum())} values")
    Bc, Hc, Wc = canvas.shape
    flat = patches.gather_flat_index(xy_all, 21, Hc, Wc)
    flat_canvas = canvas.reshape(Bc, Hc * Wc)
    lib = torch.gather(flat_canvas, 1, flat).reshape(kd.shape)
    if not torch.equal(lib, kd):
        fail("torch.gather over the flat indices differs from kernel D")
    ms_d = cuda_ms(torch, lambda: patches.gather_patches(canvas, xy_all, 21))
    plain_d = cuda_ms(torch, lambda: patches.gather_patches_plain(
        canvas, xy_all, 21))
    lib_d = cuda_ms(torch, lambda: torch.gather(flat_canvas, 1, flat))
    report["gather_patches"] = dict(
        source="orb_slam_system_tpu_torch/csrc/gather_patches.cu",
        replaces="orb_slam_system_tpu/ops/gather_pallas.py:113",
        max_abs_err=float((kd - pd).abs().max()), ms=ms_d, plain_ms=plain_d,
        # A copy: canvas and centres read once, patches written once.
        bound=bound_ms(4.0 * (canvas.numel() + xy_all.numel() + kd.numel()),
                       0.0),
        library_ms=lib_d)
    print(f"kernel D gather_patches: {tuple(kd.shape)} bit-exact; "
          f"{ms_d:.4f} ms (plain {plain_d:.4f} ms, torch.gather over "
          f"precomputed indices {lib_d:.4f} ms), {card}", flush=True)

    # The extractor's unfused route (kernel D); counts read around it.
    fb_unfused = FrameBuilder(cfg, dev, fused_gather=False)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    unfused = [fb_unfused.build(frames[i], i / 30.0)
               for i in range(N_UNFUSED_FRAMES)]
    torch.cuda.synchronize()
    unfused_launches = dict(kernels.LAUNCHES)
    if unfused_launches["gather_patches"] <= 0:
        fail("the unfused route did not launch kernel D")
    got_u = unfused[0].packed.cpu()
    ref_f = fb.build(frames[0], 0.0).packed.cpu()
    if not torch.equal(got_u[:, [0, 1, 4, 6, 7]], ref_f[:, [0, 1, 4, 6, 7]]):
        fail("unfused route: keypoints differ from the fused route")
    flips_u = _angle_bins(got_u[:, 5]) != _angle_bins(ref_f[:, 5])
    diff_u = (got_u[:, 8:16].view(torch.int32)
              != ref_f[:, 8:16].view(torch.int32)).any(dim=1)
    if bool((diff_u & ~flips_u).any()):
        fail("unfused route: descriptor bits differ beyond angle-bin flips")
    if int(flips_u.sum()) > MAX_ANGLE_BIN_FLIPS * ex.n_slots:
        fail(f"unfused route: {int(flips_u.sum())} angle-bin flips")
    print(f"unfused route over {N_UNFUSED_FRAMES} frames: launches "
          f"{unfused_launches}; frame 0 vs the fused route: keypoints "
          f"identical, {int(flips_u.sum())} angle-bin flips, descriptors "
          f"equal elsewhere", flush=True)

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
    for name in ("fast_score_nms", "gather_blur_moments", "brief_pack"):
        if launches[name] <= 0:
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

    # 5. The System, the main path; the counters count only this phase.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        slam, ate = mono_synthetic.run(SYSTEM_FRAMES, out_dir, 1000, W, H,
                                       device="cuda", verbose=True)
        n_traj = len(open(os.path.join(out_dir, "CameraTrajectory.txt")).readlines())
    torch.cuda.synchronize()
    system_launches = dict(kernels.LAUNCHES)
    recs = slam.telemetry.records
    ok_state = int(TrackingState.OK)
    init_at = next((i for i, r in enumerate(recs) if r["state"] == ok_state),
                   None)
    if init_at is None:
        fail("the System never initialized")
    post = recs[init_at + 1:]
    tracked_share = (sum(r["state"] == ok_state for r in post)
                     / max(len(post), 1))
    track_ms = [r["track_ms"] for r in recs]
    kf_map_ms = [r["mapping_ms"] for r in recs if r["mapping_ms"] > 1.0]
    print(f"system: {SYSTEM_FRAMES} frames in {time.perf_counter() - t0:.1f} s, "
          f"initialized at frame {init_at}, tracked {100 * tracked_share:.1f}% "
          f"of the {len(post)} frames after it; {slam.arena.n_keyframes()} "
          f"keyframes, {slam.arena.n_points()} map points, {n_traj} "
          f"trajectory lines; ATE RMSE (Sim3-aligned) {100 * ate:.3f} cm; "
          f"{card}", flush=True)
    print(f"system ms per frame (host clock, each ends in a device fetch): "
          f"track median {statistics.median(track_ms):.3f} max "
          f"{max(track_ms):.3f}; mapping median over all frames "
          f"{statistics.median(r['mapping_ms'] for r in recs):.3f}, over the "
          f"{len(kf_map_ms)} frames that inserted keyframes "
          f"{statistics.median(kf_map_ms) if kf_map_ms else 0.0:.3f} max "
          f"{max(kf_map_ms) if kf_map_ms else 0.0:.3f}; {card}", flush=True)
    for label, timer in (("tracking", slam.tracker.stage_ms),
                         ("mapping", slam.local_mapper.stage_ms)):
        stages = ", ".join(
            f"{k} {v:.1f} ms total / {len(timer.history[k])} calls / "
            f"median {statistics.median(timer.history[k]):.3f}"
            for k, v in sorted(timer.ms.items()))
        print(f"system {label} stages: {stages}", flush=True)
    print(f"launches in the system run: {system_launches}", flush=True)
    mapper = slam.local_mapper
    kf = slam.arena.kfs[max(slam.arena.kfs)]
    mapper.insert_keyframe(kf.id)
    profile_device(torch, "one keyframe insertion (process_pending on the "
                   "newest keyframe, re-inserted)", mapper.process_pending,
                   None)
    if kf.id in slam.arena.kfs:
        profile_device(torch, "one local BA (newest keyframe's window)",
                       lambda: mapper.local_ba(kf), None)
    if slam.get_tracking_state() != TrackingState.OK:
        fail(f"system ends {slam.get_tracking_state().name}, not OK")
    if slam.arena.n_keyframes() < 3 or slam.arena.n_points() <= 150:
        fail(f"system map too small: {slam.arena.n_keyframes()} keyframes, "
             f"{slam.arena.n_points()} points")
    if not ate < MAX_ATE_M:
        fail(f"system ATE {100 * ate:.3f} cm >= {100 * MAX_ATE_M:g} cm")
    if tracked_share < MIN_TRACKED_SHARE:
        fail(f"system tracked {100 * tracked_share:.1f}% of the frames after "
             f"initialization (< {100 * MIN_TRACKED_SHARE:g}%)")
    for name in ("fast_score_nms", "gather_blur_moments", "brief_pack"):
        if system_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the system run")

    # Launches of each kernel on the path that runs it: the System for A, B
    # and C, the extractor's unfused route for D.
    path_launches = dict(system_launches,
                         gather_patches=unfused_launches["gather_patches"])
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": path_launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        for name, r in report.items()]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
