#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code != 0) when it fails:
  1. print the card's name and power limit (nvidia-smi) and torch's CUDA;
  2. build the five CUDA kernels from orb_slam_system_tpu_torch/csrc (one
     nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version on the card, at the
     slice's shapes (all 8 pyramid levels of a rendered 640x480 frame, in
     one launch, for kernel A; its 1024 keypoint slots for kernels B, C
     and D, and the init builder's 2048 for both modes of kernel B), and
     time the kernel, its plain version and, where one PyTorch call
     computes the same function, that call (torch.gather for kernel D):
     call time from CUDA events around 20 calls, and the kernel's own
     device time per launch from torch.profiler; kernel B's describe mode
     (the System's route: canvas to angle and descriptor in one launch) is
     timed beside the chain it replaces (blur mode -> angles_from_moments
     -> kernel C), each as the device time of every kernel it launches;
     then run the extractor's unfused route (kernels A, D and C) over 10
     frames, with the launch counts read around it, and hold frame 0
     against the fused route;
  4. run the first slice at full width: a 30-frame 640x480 orbit over the
     textured plane (1000 features, 8 levels), map seeded from frame 0's
     depth at its true pose, frames 1-29 tracked through FrameBuilder.build
     and fused_track_step; check frames accepted, pose error against
     ground truth, and frame 0's features on the card against the port's
     CPU path; then hold kernel E (the pose LM, csrc/pose_lm.cu) against
     the plain `_lm` on the same card tensors, the slice's LM inputs at
     1024 slots from two starts (pose atol 1e-4, equal inlier masks and
     counts), and time both;
  5. run the System (the main path): System.track_monocular over a
     60-frame 640x480 orbit through drivers/mono_synthetic.run: two-view
     initialization on the 2048-slot builder, keyframes, local mapping;
     print per-frame and
     per-stage times, a profiler count of one keyframe insertion and one
     local BA, and check the reference's bars (state OK, >= 3 keyframes,
     > 150 map points, ATE < 3 cm) plus >= 90% of the frames after
     initialization tracked, that every kernel of the path launched
     (kernel A and kernel B's describe mode once per frame build, kernel C
     never, kernel E once per track.pose_lm span call), and that place recognition became ready (the vocabulary
     self-trained) with every live keyframe's BoW and nodes in the keyframe
     database;
  6. relocalization at full width on phase 5's System: with the state
     forced to LOST, a mid-orbit view must come back OK with its camera
     centre within 1 cm of the pose the System tracked for that frame; a
     view shifted 5 m off the orbit must stay LOST; with six decoy ids ahead
     of the real candidates it must still relocalize; each frame build
     launches kernels A and B (describe mode) once. Print each
     relocalization's wall ms, the device kernels and ms of one
     relocalization (profiler), the device ms of one epnp_ransac_batch at
     the run's candidate count (and its result on the card against the
     CPU), and the vocabulary descent of 1000 descriptors on the card
     against the numpy descent on the host, on the self-trained tree and on
     a k=10, L=6 tree (ORBvoc's shape, 1,111,111 nodes) made from a seed,
     bit-equal on the card;
  7. loop closing at full width: System.track_monocular over the 90-frame
     640x480 circle of drivers/loop_synthetic.run (phase 5's front end,
     texture scale 440, blur sigma 3.6 px over +-8 taps and noise 4.5 on
     frames 16-47, synchronous mapping, global BA on its own thread as the
     System's default). Check tests/test_e2e_loop.py's bars (>= 1 loop
     closed, >= 80 of 90 frames tracked, ATE < 10 cm), kernel A and kernel
     B's describe mode launched once per frame build (kernel C and B's blur
     mode never), and no pose-epoch violation. Print the loop's keyframe,
     its matched keyframe and the Sim3 scale, whether the global BA landed
     during the run or at shutdown, the loop closer's funnel, the wall ms of
     each loop and mapping stage, the device kernels and ms of
     sim3_ransac_batch and one global-BA chunk re-run over three calls on
     the inputs the run gave them, the call ms of optimize_sim3 and
     optimize_essential_graph over one call each (their profiled re-runs
     are phase 13's, on the long map), and the global-BA solver the run
     did not take (dense Schur or PCG) on the same chunk;
  8. stereo at KITTI width: the KITTI 00-02 settings (1241x376, bf 386.1448,
     2000 features in 2048 slots) loaded for Sensor.STEREO,
     System.track_stereo over 30 rectified pairs of phase 5's orbit at
     texture scale 440 through drivers/stereo_synthetic.run. Check
     tests/test_e2e_stereo.py's bars (initialized at frame 0, OK at the end,
     SE3-aligned ATE < 12 cm, metric span within 15%, > 150 keyframe-0
     features matched with 0 < disparity < fx) plus >= 90% of the frames
     tracked, and kernel A and kernel B's describe mode launched once per
     pair (batch 2 is one launch). Hold both kernels at the pair's batch-2
     shape against their plain versions and time them there (device, call
     and plain ms, bound); print stereo_match's wall, call and device ms
     and kernel count on the run's inputs, and the track and mapping
     medians;
  9. RGB-D and localization mode: phase 5's 640x480 camera with bf 40,
     DepthMapFactor 5000 and th_depth 40 * 40 / 520 m for Sensor.RGBD,
     System.track_rgbd over 30 frames of the orbit with the analytic depth
     x 5000 (drivers/rgbd_synthetic.run), then localization mode with the
     last frame's map associations wiped for 8 more frames. Check
     tests/test_e2e_rgbd.py's bars (>= 58 of 60 tracked, ATE < 5 cm, SE3-
     aligned here, span within 10%, > 200 map points, keyframe 0's depths
     inside (1, 10) m), that VO points carried the first map-less frame and
     the last one is OK, and kernel A and B's describe mode launched once
     per frame.
 10. the realtime modes through the System's entry points, each run with
     the kernel counters set to 0 before it and read after it, and a count
     of the frame builds beside them (kernel A and B's describe mode must
     launch once per build; a frame the chain drops and builds again
     counts twice):
     a. bench.py's bench_system_fps shape: phase 5's front end over the
        first 40 frames of a 72-frame orbit in u8,
        System(async_mapping=True), 16 classic frames, 8 pipelined warm-up
        frames, then 16 timed frames through
        track_monocular_pipelined(depth=2): fps over the 16, chain_stats,
        kf_wait_stats, the tracking and mapping stage medians; bars >= 90%
        of the timed frames OK, OK at the end, ATE < 3 cm, >= 1 chain
        accept. Then one chain step from enqueue to its event wait on the
        finished map, profiled (kernels, device ms, idle share). Then a
        fresh async System: 24 classic frames and the same 16 through
        track_monocular_stream, its fps beside phase 5's classic per-frame
        time, with the same bars but the chain's;
     b. phase 7's loop circle through track_monocular_pipelined: >= 1 loop
        closed, >= 80 of 90 frames tracked, ATE < 10 cm, no pose-epoch
        violation;
     c. 30 of phase 8's KITTI-width pairs through track_stereo_pipelined:
        initialized at frame 0, >= 90% OK, ATE < 12 cm, >= 1 chain accept
        (one keyframe arms a stereo chain).
 11. sequences and maps from disk, through the dataset entry points:
     a. build the native decoder (native/dataloader.cpp, g++) and print
        g++'s version;
     b. write four synthetic sequences in their datasets' layouts under a
        temporary folder, 8-bit frames and 16-bit depth as PNGs from
        models/viewer.encode_png: TUM mono (the first 30 frames of 10a's u8
        orbit, rgb.txt, TUM groundtruth.txt), TUM RGB-D (phase 9's camera,
        20 frames, depth.txt, associations.txt, DepthMapFactor 5000), KITTI
        stereo (the first 20 of phase 8's 1241x376 pairs, image_0 /
        image_1, times.txt, KITTI-format poses) and EuRoC mono (20 frames
        of a 752x480 camera with EuRoC cam0's intrinsics under
        mav0/cam0/data/<ns>.png, a timestamp file, its settings file);
     c. run each through drivers/run_dataset.py's main (in this process,
        unpaced, an ATE gate): TUM mono with a k=10, L=2 ORBvoc-format
        vocabulary made from a seed, the others self-trained. Bars: TUM
        mono OK at the end, >= 3 keyframes, > 150 points, Sim3 ATE < 3 cm;
        RGB-D >= n - 2 frames tracked, SE3 ATE < 5 cm; KITTI stereo >= 90%
        tracked, SE3 ATE < 12 cm (CameraTrajectory.txt, KITTI format);
        EuRoC all 20 frames read from mav0/cam0, >= 90% tracked after
        initialization, Sim3 ATE < 3 cm; kernel A and B's describe mode once
        per frame build in every run;
     d. save the TUM mono run's map (file bytes, save and load ms), load it
        into a fresh System in localization mode: frame 15's view must
        relocalize with its camera centre within 1 cm of the pose the run
        tracked for it, and 5 more frames stay OK with no keyframe added;
        then load the same file into the run's own System: its first
        relocalized pose must equal the fresh System's within 1e-4;
     e. print the decode ms per frame (one-shot, and through the prefetch
        ring as the drivers wait on it) beside the track ms per frame.
 12. the multi-sequence mode (BASELINE.json config 5), the counters read
     around each run:
     a. S = 5 full Systems through drivers/multiseq_throughput.run_full and
        MultiSystem.track_batch, 20 frames each at the camera and extractor
        of settings/euroc_mono.yaml (752x480 pinhole, 1000 features, 8
        levels), synchronous mapping; per sequence the bars of
        tests/test_multiseq_system.py (OK at the end, >= 3 keyframes, > 100
        points, Sim3 ATE < 5 cm, a trajectory file of > 10 lines) plus >= 90%
        tracked after initialization; one batched extraction per round with
        a steady sequence and none otherwise, kernels A and B's describe
        mode once per such round plus once per classic build; on one round's
        images the batch-5 pack equal to five single packs bit for bit.
        Print the aggregate fps, each sequence's track and mapping medians,
        the batched extraction's share of a round, and kernels A and B at
        batch 5 against their plain versions with times and bounds;
     b. the batched front-end step (parallel/multiseq) through
        run_frontend: 8 sequences at 320x240, 512 features, 4 levels, over
        20 rendered frames (A and B once per step); its last call on the
        card against the same step on the CPU (totals equal, poses within
        1e-3, rotations orthonormal within 1e-3), then a tracked state the
        same way (totals within 1%); print the step's kernels, device, call
        and wall ms and the aggregate front-end fps.
 13. the long run, the viewer and the AR overlay, the counters read around
     each run:
     a. the endurance clover (drivers/endurance_synthetic.run; the
        candidate of BASELINE.json config 2, KITTI 00's long trajectory
        with loop closure): its first circle, 250 frames at the JAX gate's
        ~4.5 cm a frame, back to the junction, 320x240, 400 features,
        System.track_monocular with the synchronous mapper and the global
        BA on its own thread.
        Bars: >= 90% tracked, >= 1 loop closed, a global BA solved through
        bundle_adjust_cg past GBA_DENSE_MAX_CAMS (48) keyframes and
        applied (spies on local_ba's two solvers and on GBARunner count
        each chunk's solver and keyframes), a peak of >= 49 keyframes, ATE
        < 12 cm, no pose-epoch violation, the last third's host-ms median
        within 2.5x the first third's, kernel A and B's describe mode once
        per frame build (C and B's blur mode never). Print C for every
        solve, the mapper's stage ms over its first and last 20 calls, the
        keyframes and points at the end and at the peak, the peak device
        memory (torch.cuda.max_memory_allocated); then, on the run's
        inputs, the kernels, device ms and call ms of one PCG global-BA
        chunk past 48 keyframes and of the dense Schur solve on the same
        chunk (the cut-over), and of the last essential graph and
        OptimizeSim3, each profiled over one call; and the saved map's
        bytes per keyframe;
     b. on 13a's System: annotate_frame and status_text on the last frame
        (a box drawn, the state named), export_map_ply of the long map
        (ms, bytes, the vertex count), a LiveViewer on a free localhost
        port: one update(), its map JSON parsed with the map's keyframe
        count, an annotated frame served, shut down; then ARDemo.process
        on a fresh System over the first 30 frames of phase 5's cached
        640x480 orbit: a plane fitted, cube pixels drawn on a tracked
        frame, A and B once per frame build.
 14. the last modules (the ROS bridge, the live and video drivers, the warm
     pass, the sharded solvers), the counters read around each run:
     a. the four ROS nodes (drivers/ros_*.py), each main through a
        dataio/ros_replay.ReplayRospy that replays its messages in spin():
        ros_mono over 30 of phase 5's cached renders as mono8 (its settings
        written with config.save_settings_yaml; OK at the end, >= 90%
        tracked after initialization, >= 3 KeyFrameTrajectory.txt rows,
        Sim3 ATE < 3 cm), ros_stereo over phase 8's first 10 KITTI-width
        pairs with do_rectify false, the right stamps jittered within 4 ms
        (every pair paired, OK at the end, a CameraTrajectory.txt row a
        pair), ros_rgbd over phase 9's first 10 frames with 32FC1 depth (OK,
        both trajectory files written) and ros_mono_ar over 10 of phase 5's
        renders (an overlay a message); A and B's describe mode once per
        frame build in each;
     b. live_camera.run over 24 BGR copies of phase 5's renders from a fake
        capture, pipelined with the async mapper (24 frames, OK at the end);
        video_slam.main over a folder of 20 of them as PNGs and one .txt
        file (20 frames read, the trajectory written); where ffmpeg is on
        PATH, iter_video over the same frames encoded losslessly (the
        output says whether it ran);
     c. System(prewarm=True) on phase 5's config, 16 frames a mode: each
        mode's seconds, then the track ms of its first 5 frames beside
        phase 5's first 5;
     d. an in-process NCCL group of one rank on card 0: the sharded global
        BA on 13a's PCG chunk and the sharded essential graph on 13a's last
        inputs, each bit-equal to the unsharded solve of the same inputs,
        with call ms and kernels beside the unsharded call's; then
        multiseq.dryrun(1) on the group (the dp x sp step, both sharded
        solvers at JAX's dry-run sizes, a 2-System MultiSystem; A and B's
        describe mode once per extraction), and dryrun_multichip across the
        cards where there are several.
To make room for phase 14 inside the script's clock, phase 10a times 16
frames in each mode (48 before phase 14 came) and phase 12a runs 20
frames a sequence (30 before); their bars are shares of the frames.
The synthetic frames are rendered on the host, and later phases render poses
of earlier ones again: memoize_renders serves a repeat from a cache (the
same image), and the script prints its clock after each phase. The
second-to-last line is a JSON object with each kernel's launches (on the
path that runs it, and in every phase), error, times and bound; the last
line is {"ok": true, "device": {...}}. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
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
MAX_RELOC_ERR_M = 0.01      # relocalized camera centre vs the tracked one
MIN_TRACKED_SHARE = 0.9     # of the System's frames after initialization
MAX_ATE_M = 0.03            # tests/test_e2e_mono.py bar
LOOP_FRAMES = 90            # tests/test_e2e_loop.py's short circle
MIN_LOOP_TRACKED = 80       # ... and its bars
MAX_LOOP_ATE_M = 0.10
# Timed over one call, profiled in phase 13 on the long map's inputs.
SLOW_SOLVES = ("optimize_sim3", "optimize_essential_graph")
# Phases 8 and 9 ran 60 frames each until phase 10 came; 30 keep the
# script's time (the bars are shares of the frames).
STEREO_FRAMES = 30          # phase 8: KITTI-width stereo pairs
MAX_STEREO_ATE_M = 0.12     # tests/test_e2e_stereo.py's bars
MAX_SPAN_ERR_STEREO = 0.15
RGBD_FRAMES = 30            # phase 9
REALTIME_FRAMES = 72        # phase 10a: bench_system_fps's orbit, of which
REALTIME_RUN = 40           # the first 40 run (all 72 before phase 14): its
REALTIME_CLASSIC = 16       # classic frames, then
REALTIME_WARM = 8           # pipelined warm-up frames, then the timed rest
REALTIME_STEREO = 30        # phase 10c: KITTI-width pairs
LOCALIZE_FRAMES = 8         # ... then in localization mode
MAX_RGBD_ATE_M = 0.05       # tests/test_e2e_rgbd.py's bars
MAX_SPAN_ERR_RGBD = 0.10
TEX_SCALE = 440.0           # phase 5's texture scale
SEQ_TUM_FRAMES = 30         # phase 11: the first 30 of 10a's u8 orbit
SEQ_FRAMES = 20             # phase 11's RGB-D, KITTI stereo and EuRoC runs
MAP_FRAME = 15              # phase 11d: the view relocalized on a loaded map
MAP_MORE_FRAMES = 5         # ... and the frames tracked after it
MAX_LOAD_DIFF = 1e-4        # used-System load against a fresh System's
MULTISEQ_SEQS = 5           # phase 12a: BASELINE.json config 5, MH01-05
MULTISEQ_FRAMES = 20        # ... frames per sequence (30 before phase 14)
MAX_MULTISEQ_ATE_M = 0.05   # tests/test_multiseq_system.py's bar
FRONTEND_SEQS = 8           # phase 12b: the JAX example's --frontend shape
FRONTEND_FRAMES = 20
# Phase 13a: the endurance clover's first circle, 250 frames at the JAX
# gate's ~4.5 cm a frame (the first 250 frames of its 500-frame, 2-leaf
# run); the loop at the junction closes after ~63 keyframes. The second
# circle, with its closure at ~114 keyframes, would take the script past
# 1,000 s: it runs in tests/test_torch_endurance.py.
LONG_FRAMES = 250
LONG_LEAVES = 1
LONG_FEATURES = 400
MAX_LONG_ATE_M = 0.12       # tests/test_endurance.py's bars
MAX_THIRDS_RATIO = 2.5
AR_FRAMES = 30              # phase 13b: ARDemo over phase 5's first frames
ROS_MONO_FRAMES = 30        # phase 14a: ros_mono over phase 5's first renders
ROS_FRAMES = 10             # ... the stereo, RGB-D and AR nodes' messages
LIVE_FRAMES = 24            # phase 14b: live_camera's fake capture
VIDEO_FRAMES = 20           # ... video_slam's PNG folder
WARM_FRAMES = 16            # phase 14c: frames of each warm mode
WARM_AFTER = 5              # ... then phase 5's first frames tracked
# EuRoC cam0's intrinsics (examples/settings/euroc_mono.yaml) without its
# distortion: the renderer is a pinhole.
EUROC_W, EUROC_H = 752, 480
EUROC_K = (458.654, 457.296, 367.215, 248.375)
# H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SPIN_LEAD = 512             # spin kernels that open each profiler window


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


def _device_events(prof, kernel=None):
    """The profile's device kernels whose name contains `kernel` (None:
    all), without the spin kernel that opens each window."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and "spin_kernel" not in e.key
            and (kernel is None or kernel in e.key)]


def _open_window(torch):
    """Open a profiler window with SPIN_LEAD short spin kernels and wait for
    them. Late in this script's process (after the System's profiles) the
    profiler drops the first records of every window, 5-8 in phase 6 and
    up to 42 after phase 7's essential-graph windows (the loss grows with
    the records profiled before); the spin kernels take that loss instead
    of the measured calls."""
    for _ in range(SPIN_LEAD):
        torch.cuda._sleep(20000)
    torch.cuda.synchronize()


def device_ms(torch, fn, kernel, reps: int = 20, launches: int = 1) -> float:
    """Device ms per launch of the kernel whose name contains `kernel`
    (None: any kernel fn launches), from torch.profiler over `reps` calls of
    fn after a warm-up; fn launches it `launches` times per call. The
    profiler has been seen to drop kernel records on the H100 machine, so a
    window that does not hold all reps * launches records is profiled
    again, up to 5 windows; the run fails if none holds them all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = reps * launches
    for window in range(1, 6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_window(torch)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = _device_events(prof, kernel)
        n = sum(e.count for e in evs)
        if n == want:
            return sum(e.self_device_time_total for e in evs) / 1e3 / n
        print(f"profiler window {window}: {n} of {want} records of kernel "
              f"{kernel!r}", flush=True)
    fail(f"the profiler never showed all {want} launches of kernel {kernel!r}")


def _stage_window(torch, fn, reps: int):
    """({kernel name: records}, summed device us, spin records) of one
    profiler window of `reps` calls of fn."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window(torch)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    counts: dict = {}
    t_us = 0.0
    for e in _device_events(prof):
        counts[e.key] = counts.get(e.key, 0) + e.count
        t_us += e.self_device_time_total
    spins = sum(e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and "spin_kernel" in e.key)
    return counts, t_us, spins


def stage_device_ms(torch, fn, reps: int = 20, required: bool = True):
    """(device ms per call of fn summed over every kernel it launches, the
    kernels per call). One call's kernels, by name, come from single-call
    windows, two of which agree; the time from a window of `reps` calls
    that holds exactly `reps` times those records. The profiler can drop
    records (never add them), so each kind of window is profiled again, up
    to 5, and where no two single-call windows agree each kernel's largest
    count over them stands for one call. If no window of `reps` calls
    qualifies, the run fails, or, where the stage's time is not `required`
    (the 30,000-115,000-kernel solves of phase 7, whose windows lose
    records most, and stereo_match), the device time is reported as not
    measured (None)."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        one, t_us, _ = _stage_window(torch, fn, 1)
        if one and one in seen:
            if reps == 1:
                # This window holds exactly one call's records: it is the
                # window of `reps` calls.
                return t_us / 1e3, sum(one.values())
            break
        seen.append(one)
    else:
        one = {k: max(c.get(k, 0) for c in seen) for k in set().union(*seen)}
        print(f"no two single-call profiler windows of the stage agree "
              f"({[sum(c.values()) for c in seen]} records): one call taken "
              f"as each kernel's largest count, {sum(one.values())} records",
              flush=True)
    want = {k: reps * v for k, v in one.items()}
    for window in range(1, 6):
        counts, t_us, spins = _stage_window(torch, fn, reps)
        if counts == want:
            if spins != SPIN_LEAD:
                print(f"the profiler dropped {SPIN_LEAD - spins} of the "
                      f"{SPIN_LEAD} spin records that opened the window",
                      flush=True)
            return t_us / 1e3 / reps, sum(one.values())
        off = {k: (counts.get(k, 0), want.get(k, 0))
               for k in set(counts) | set(want)
               if counts.get(k, 0) != want.get(k, 0)}
        print(f"profiler window {window} of {reps} calls: "
              f"{sum(counts.values())} records, not {sum(want.values())}, "
              f"{spins} of {SPIN_LEAD} spin records; (records, wanted) of "
              f"the kernels off: {off}", flush=True)
    msg = (f"the profiler never showed {reps} times the {sum(one.values())} "
           f"kernels of one call of the stage")
    if required:
        fail(msg)
    print(f"{msg}: device time not measured", flush=True)
    return None, sum(one.values())


def ms_text(ms, fmt: str = ".3f") -> str:
    """A measured ms, or "not measured" for None."""
    return "not measured" if ms is None else format(ms, fmt) + " ms"


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
    call itself, which the profiler inflates). An exception from fn fails
    the run; if the profiler itself fails, say so and go on. Returns
    (kernels, device ms, wall ms), or None where the profiler failed."""
    from torch.profiler import ProfilerActivity, profile
    prof, why = profile(activities=[ProfilerActivity.CUDA]), None
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 - the profiler's own failure
        prof, why = None, e
    _open_window(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if wall_ms is None:
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if prof is not None:
        try:
            prof.stop()
            evs = _device_events(prof)
        except Exception as e:  # noqa: BLE001 - the profiler's own failure
            prof, why = None, e
    if prof is None:
        print(f"{label}: device kernels not measured ({why})", flush=True)
        return None
    n = sum(e.count for e in evs)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    print(f"{label}: {n} device kernels, {dev_ms:.3f} ms summed device "
          f"time (profiler), wall {wall_ms:.3f} ms, device idle share "
          f"{1.0 - dev_ms / wall_ms:.3f}", flush=True)
    return n, dev_ms, wall_ms


def check_kernel_b(canvas, xy):
    """Both modes of kernel B against their plain versions: blur mode
    bit-exact (moments within 0.5); describe mode's moments bit-equal
    to blur mode's, its angle to angles_from_moments of them, its
    descriptors to brief_pack_plain of the plain blur at that angle."""
    import torch

    from orb_slam_system_tpu_torch.ops import brief, patches
    from orb_slam_system_tpu_torch.ops.brief import _angle_bins
    from orb_slam_system_tpu_torch.ops.orientation import angles_from_moments
    kb, km = patches.gather_blur_moments(canvas, xy, 21)
    pb, pm = patches.gather_blur_moments_plain(canvas, xy, 21)
    if not torch.equal(kb, pb):
        fail(f"kernel B blur differs at {xy.shape[1]} slots: "
             f"{int((kb != pb).sum())} values, max "
             f"{float((kb - pb).abs().max())}")
    mom_err = float((km - pm).abs().max())
    if not mom_err <= 0.5:
        fail(f"kernel B moments differ by {mom_err} (> 0.5)")
    dm, da, dd = patches.gather_blur_describe(canvas, xy, 21)
    if not torch.equal(dm, km):
        fail(f"describe mode's moments differ from blur mode's in "
             f"{int((dm != km).sum())} values")
    ka = angles_from_moments(km)
    if not torch.equal(da, ka):
        fail(f"describe mode's angle differs from angles_from_moments in "
             f"{int((da != ka).sum())} keypoints, max "
             f"{float((da - ka).abs().max())}")
    pd = brief.brief_pack_plain(pb, da)
    if not torch.equal(dd, pd):
        fail(f"describe mode's descriptors differ in "
             f"{int((dd != pd).any(-1).sum())} keypoints")
    flips = int((_angle_bins(da) != _angle_bins(angles_from_moments(pm)))
                .sum())
    print(f"kernel B at {xy.shape[1]} slots, canvas {tuple(canvas.shape)}: "
          f"blur mode bit-exact, moments max err {mom_err:.3g} (angle-bin "
          f"flips against the plain moments: {flips}); describe mode's "
          f"moments, angle and descriptors bit-equal", flush=True)
    return pb, pm, mom_err


def canvas_floats_read(torch, patches, canvas, xy) -> int:
    """Canvas floats that a gather of kernels B and D must read: those inside
    the union of the keypoints' clipped 43x43 windows. The rest of the
    canvas is filler (each level padded to the widest, rows rounded up to 8)
    and canvas that no keypoint of this frame reaches."""
    Bc, Hc, Wc = canvas.shape
    flat = patches.gather_flat_index(xy, 21, Hc, Wc)
    return int(torch.zeros((Bc, Hc * Wc), dtype=torch.bool, device=canvas.device)
               .scatter_(1, flat, True).sum())


def describe_bound(n_read: int, xy, pb_side: int):
    """Bound of kernel B's describe stage: the windows' canvas and the
    centres read once; moments, angle and descriptor written once; the
    first blur pass, the second at the 512 test points, the moments and per
    rBRIEF test two bf16 roundings and a compare."""
    n_kp = xy.shape[0] * xy.shape[1]
    ops_pass1 = 2 * 7 * pb_side * 43
    return bound_ms(4.0 * (n_read + xy.numel() + 11 * n_kp),
                    n_kp * (ops_pass1 + 2 * 7 * 512 + 4 * 749) + 3.0 * 256 * n_kp)


def check_kernel_e(torch, dev, Tcw, Xw, obs, inv_s2, ok, ur, cam,
                   card) -> dict:
    """Kernel E (csrc/pose_lm.cu) against the plain `_lm` on the same card
    tensors at the main path's shape, phase 4's LM inputs (1,024 slots),
    from the frame's own pose and from a start 2 cm and ~0.6 degrees off
    it: pose atol 1e-4, equal inlier masks and counts. Returns its report
    entry, with call, device and plain ms and its bound."""
    from orb_slam_system_tpu_torch.solvers import pose_opt
    f32 = torch.float32
    Xw, obs, inv_s2, ur = (t.to(f32).contiguous() for t in (Xw, obs, inv_s2,
                                                            ur))
    ok = ok.contiguous()
    c, s = np.cos(0.01), np.sin(0.01)
    off = np.eye(4, dtype=np.float32)
    off[:2, :2] = [[c, -s], [s, c]]
    off[:3, 3] = 0.02 / np.sqrt(3.0)
    starts = (Tcw.to(f32).contiguous(), torch.from_numpy(off).to(dev) @ Tcw)
    lens = (cam.fx, cam.fy, cam.cx, cam.cy)
    err = 0.0
    for start in starts:
        kT, k_in, k_n = pose_opt.pose_lm(start, Xw, obs, ur, inv_s2, ok,
                                         *lens, cam.bf)
        pT, p_in, p_n = pose_opt._lm(start, Xw, obs, inv_s2, ok, *lens, ur,
                                     cam.bf, 4, 10, None)
        e = float((kT - pT).abs().max())
        if not e <= 1e-4 or not torch.equal(k_in, p_in) or not torch.equal(
                k_n, p_n):
            fail(f"kernel E against the plain LM: pose error {e:.3g}, "
                 f"{int((k_in != p_in).sum())} inlier flags differ, "
                 f"{int(k_n)} vs {int(p_n)} inliers")
        err = max(err, e)
    run_e = lambda: pose_opt.pose_lm(starts[1], Xw, obs, ur, inv_s2, ok,
                                     *lens, cam.bf)
    ms_e = cuda_ms(torch, run_e)
    dev_e = device_ms(torch, run_e, "pose_lm_kernel")
    plain_e = cuda_ms(torch, lambda: pose_opt._lm(
        starts[1], Xw, obs, inv_s2, ok, *lens, ur, cam.bf, 4, 10, None), 3)
    n = Xw.shape[0]
    # The edges (7 floats and a flag) and the pose read once, the pose,
    # flags and count written once; per edge and iteration ~294 operations
    # (the residual and Jacobian, 27 weighted sums, the trial residual),
    # ~38 a reclassification.
    bound = bound_ms(4.0 * 7 * n + 2 * n + 4.0 * 32 + 8,
                     float(n) * (294 * 40 + 38 * 4))
    print(f"kernel E pose_lm at {n} slots: agrees with the plain LM (pose "
          f"error {err:.3g}, masks and counts equal) from the true pose and "
          f"from a start 2 cm off; call {ms_e:.4f} ms, device {dev_e:.4f} ms "
          f"({1e3 * dev_e / 40:.2f} us an iteration; plain {plain_e:.4f} ms), "
          f"bound {bound[0]:.5f} ms ({bound[1]}): the serial chain of 40 "
          f"iterations, each two passes, two block reductions and a 6x6 "
          f"solve, holds it; {card}", flush=True)
    return dict(source="orb_slam_system_tpu_torch/csrc/pose_lm.cu",
                replaces=None, max_abs_err=err, ms=ms_e, device_ms=dev_e,
                plain_ms=plain_e, bound=bound, library_ms=None, slots=n,
                iterations=40)


def orbvoc_shaped_tree(Vocabulary, k: int = 10, L: int = 6, seed: int = 0):
    """A complete k-ary tree of depth L (ORBvoc.txt's shape: 1,111,111 nodes
    at k=10, L=6) in breadth-first numbering, with random descriptors and
    leaf weights from a seed; no text file."""
    rng = np.random.default_rng(seed)
    n = (k ** (L + 1) - 1) // (k - 1)
    ids = np.arange(n, dtype=np.int64)
    children = k * ids[:, None] + np.arange(1, k + 1)
    children[children >= n] = -1
    parent = (ids - 1) // k
    parent[0] = -1
    is_leaf = children[:, 0] < 0
    word_of_node = np.full(n, -1, np.int32)
    word_of_node[is_leaf] = np.arange(int(is_leaf.sum()), dtype=np.int32)
    weight = np.where(is_leaf, rng.uniform(0.1, 5.0, n), 0.0).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)
    return Vocabulary(k, L, desc, parent.astype(np.int32),
                      children.astype(np.int32), is_leaf, weight, word_of_node)


def relocalization_phase(torch, slam, kernels, pnp, unpack, Vocabulary,
                         traj_io, mono_synthetic, TrackingState, card) -> dict:
    """Phase 6 (see the module docstring); returns its numbers."""
    W, H = slam.cfg.camera.width, slam.cfg.camera.height
    cfg = mono_synthetic.make_config(W, H, slam.cfg.orb.n_features)
    renderer = mono_synthetic.make_renderer(cfg)
    poses = mono_synthetic.orbit_trajectory(SYSTEM_FRAMES, radius=0.35,
                                            depth=-2.0, tilt=0.3)
    tr = slam.tracker
    # The tracked pose of each frame, and metres per map unit from the
    # Sim3 alignment of the tracked camera centres to the true ones.
    fp = [(int(round(ts * 30.0)), T) for ts, T, lost in
          traj_io.frame_poses(slam.arena, tr.trajectory) if not lost]
    P = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in fp])
    Q = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i, _ in fp])
    Pa = traj_io.umeyama_align(P, Q)
    m_per_unit = float(np.sqrt(((Pa - Pa.mean(0)) ** 2).sum()
                               / ((P - P.mean(0)) ** 2).sum()))
    mid, T_tracked = min(fp, key=lambda e: abs(e[0] - SYSTEM_FRAMES // 2))
    img_mid = renderer.render(poses[mid])
    T_far = poses[0].copy()
    T_far[:3, 3] += np.array([5.0, 5.0, 0.0])
    img_far = renderer.render(T_far)

    def lost_then(img, ts):
        tr.state = TrackingState.LOST
        tr.velocity = None
        return slam.track_monocular(img, ts)

    # The main path of this phase: three relocalization attempts, the
    # counters read around them. The PnP call's inputs are kept to time it.
    captured = []
    orig_pnp = pnp.epnp_ransac_batch

    def spy(*a, **kw):
        captured.append((a, kw))
        return orig_pnp(*a, **kw)

    db = slam.place_rec.db
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    pnp.epnp_ransac_batch = spy
    try:
        Tcw = lost_then(img_mid, 1000.0)
        state_mid = slam.get_tracking_state()
        lost_then(img_far, 1001.0)
        state_far = slam.get_tracking_state()
        far_stats = dict(tr.reloc_stats)
        decoys = [99991, 99992, 99993, 99994, 99995, 99996]
        orig_detect = db.detect_reloc_candidates
        db.detect_reloc_candidates = lambda bow, arena: (
            decoys + orig_detect(bow, arena)[::-1])
        try:
            T_decoy = lost_then(img_mid, 1002.0)
            state_decoy = slam.get_tracking_state()
        finally:
            del db.detect_reloc_candidates
    finally:
        pnp.epnp_ransac_batch = orig_pnp
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    reloc_ms = list(tr.stage_ms.history["relocalization"])[-3:]
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]
    err_units = float(np.linalg.norm(centre(Tcw) - centre(T_tracked)))
    err_decoy = float(np.linalg.norm(centre(T_decoy) - centre(T_tracked)))
    print(f"relocalization of frame {mid}'s view: {state_mid.name}, camera "
          f"centre {err_units:.5f} map units = {100 * err_units * m_per_unit:.3f}"
          f" cm from the tracked pose ({m_per_unit:.4f} m per unit); view "
          f"5 m off the orbit: {state_far.name}; decoys first: "
          f"{state_decoy.name} ({100 * err_decoy * m_per_unit:.3f} cm); "
          f"reloc_stats {far_stats} then {dict(tr.reloc_stats)}; wall ms per "
          f"relocalization (host clock) {[round(x, 3) for x in reloc_ms]}; "
          f"launches {launches}; {card}", flush=True)
    if state_mid != TrackingState.OK or state_decoy != TrackingState.OK:
        fail("the mid-orbit view did not relocalize")
    if err_units * m_per_unit >= MAX_RELOC_ERR_M or \
            err_decoy * m_per_unit >= MAX_RELOC_ERR_M:
        fail(f"relocalized {100 * err_units * m_per_unit:.3f} / "
             f"{100 * err_decoy * m_per_unit:.3f} cm from the tracked pose "
             f"(>= {100 * MAX_RELOC_ERR_M:g} cm)")
    if state_far != TrackingState.LOST:
        fail("the view 5 m off the orbit relocalized")
    check_build_launches("phase 6", launches, 3)
    if not captured:
        fail("no EPnP-RANSAC call in phase 6")

    # One relocalization under the profiler, on a fresh build of the view.
    tr.current = tr.builder.build(img_mid, 1003.0)
    profile_device(torch, "one relocalization (tracker.relocalization)",
                   tr.relocalization, None)

    # One epnp_ransac_batch at the run's candidate count, on the card and
    # against the same call on the CPU.
    a, kw = captured[0]
    n_cand = int(a[0].shape[0])
    run_pnp = lambda: orig_pnp(*a, **kw)
    pnp_ms = cuda_ms(torch, run_pnp)
    pnp_dev, pnp_kernels = stage_device_ms(torch, run_pnp)
    ok_g, T_g, inl_g, _ = (x.cpu() for x in run_pnp())
    cpu_args = [x.cpu() if torch.is_tensor(x) else x for x in a]
    ok_c, T_c, inl_c, _ = orig_pnp(*cpu_args, **kw)
    n_slots = inl_g.shape[1]
    inl_diff = int((inl_g != inl_c).sum(1).max())
    t_diff = float((T_g[:, :3, 3] - T_c[:, :3, 3]).abs().max())
    print(f"epnp_ransac_batch at {n_cand} candidates x 300 sets x {n_slots} "
          f"slots: device {pnp_dev:.4f} ms in {pnp_kernels} kernels, call "
          f"{pnp_ms:.3f} ms; card vs CPU: ok {ok_g.tolist()} / {ok_c.tolist()},"
          f" inlier masks differ in at most {inl_diff} slots, translation by "
          f"{t_diff:.2e}; {card}", flush=True)
    if not torch.equal(ok_g, ok_c) or inl_diff > 0.01 * n_slots:
        fail("epnp_ransac_batch on the card disagrees with the CPU")

    # The vocabulary descent: card (torch) against host (numpy), bit-equal.
    _, _, _, valid, desc, _ = unpack(tr.current.packed)
    desc, valid = desc[:1000].contiguous(), valid[:1000].contiguous()
    desc_np = desc.cpu().numpy().view(np.uint32)
    valid_np = valid.cpu().numpy()
    descent = {}
    for label, voc in (("self_trained", slam.place_rec.vocab),
                       ("k10_L6", orbvoc_shaped_tree(Vocabulary))):
        got = [x.cpu().numpy() for x in voc.transform_device(desc, valid)]
        want = voc.transform(desc_np, valid_np)
        if not all(np.array_equal(g.view(np.int32), w.view(np.int32))
                   for g, w in zip(got, want)):
            fail(f"the descent on the card differs from numpy ({label})")
        run_d = lambda: voc.transform_device(desc, valid)
        d_call = cuda_ms(torch, run_d)
        d_dev, d_kernels = stage_device_ms(torch, run_d)
        t0 = time.perf_counter()
        for _ in range(20):
            voc.transform(desc_np, valid_np)
        host_ms = 1e3 * (time.perf_counter() - t0) / 20
        descent[label] = dict(nodes=len(voc.node_parent), device_ms=d_dev,
                              kernels=d_kernels, call_ms=d_call,
                              numpy_host_ms=host_ms)
        print(f"vocabulary descent of 1000 descriptors, {label} tree "
              f"({len(voc.node_parent)} nodes, L={voc.L}): bit-equal on the "
              f"card; device {d_dev:.4f} ms in {d_kernels} kernels, call "
              f"{d_call:.3f} ms; numpy on the host {host_ms:.3f} ms; {card}",
              flush=True)
    return dict(frame=mid, err_cm=100 * err_units * m_per_unit,
                err_decoy_cm=100 * err_decoy * m_per_unit,
                reloc_wall_ms=reloc_ms, launches=launches,
                reloc_stats=dict(tr.reloc_stats), pnp_candidates=n_cand,
                pnp_device_ms=pnp_dev, pnp_kernels=pnp_kernels,
                pnp_call_ms=pnp_ms, descent=descent)


def loop_phase(torch, dev, kernels, loop_synthetic, loop_closing, sim3,
               pose_graph, local_ba, card) -> dict:
    """Phase 7 (see the module docstring); returns its numbers. The solver
    calls of the run are recorded (inputs kept) to time them afterwards, by
    spies set on the solver modules: they see the calls that loop_closing
    makes through the module attribute (sim3.sim3_ransac_batch, ...), and
    a solver it imported by name would be reported missing."""
    W, H = 640, 480
    captured: dict = {}
    spied = [(sim3, "sim3_ransac_batch"), (pose_graph, "optimize_sim3"),
             (pose_graph, "optimize_essential_graph"),
             (local_ba, "bundle_adjust"), (local_ba, "bundle_adjust_cg")]
    originals = {name: getattr(mod, name) for mod, name in spied}

    def spy(name):
        key = name
        if name.startswith("bundle_adjust"):
            key = "gba_chunk"

        def call(*a, **kw):
            # A global-BA chunk is a bundle_adjust(_cg) call of CHUNK_ITERS
            # iterations (local BA runs 5 and 10).
            if key != "gba_chunk" or (
                    kw.get("n_iters") == loop_closing.GBARunner.CHUNK_ITERS):
                captured.setdefault(key, (originals[name], a, kw))
            return originals[name](*a, **kw)
        return call

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for mod, name in spied:
        setattr(mod, name, spy(name))
    t0 = time.perf_counter()
    try:
        slam, ate, n_tracked = loop_synthetic.run(
            LOOP_FRAMES, None, 1000, W, H, device=dev.type, verbose=True)
    finally:
        for mod, name in spied:
            setattr(mod, name, originals[name])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lc = slam.loop_closer
    recs = slam.telemetry.records
    landed = next((i for i, r in enumerate(recs) if r["gba_applied"] > 0), None)
    gba_when = ("not applied" if lc.n_gba_applied == 0 else
                "at shutdown" if landed is None else
                f"during the run, after frame {landed}")
    print(f"loop circle: {LOOP_FRAMES} frames {W}x{H} in {wall_s:.1f} s; loops "
          f"closed {lc.n_loops_closed} (last: keyframe, matched keyframe, "
          f"Sim3 scale {lc.last_loop}); {n_tracked}/{LOOP_FRAMES} frames tracked; ATE "
          f"RMSE (Sim3-aligned) {100 * ate:.3f} cm; {slam.arena.n_keyframes()} "
          f"keyframes, {slam.arena.n_points()} map points; global BAs applied "
          f"{lc.n_gba_applied}, {gba_when}; pose epoch "
          f"{slam.arena.pose_epoch}, epoch violations "
          f"{slam.tracker.epoch_violations}; loop_closer.stats "
          f"{dict(lc.stats)}; launches {launches}; {card}", flush=True)
    stage_ms = {}
    for label, timer in (("tracking", slam.tracker.stage_ms),
                         ("mapping", slam.local_mapper.stage_ms),
                         ("loop closing", lc.stage_ms)):
        stage_ms[label] = {k: dict(total_ms=v, calls=len(timer.history[k]),
                                   max_ms=max(timer.history[k]))
                           for k, v in timer.ms.items()}
        print(f"loop circle {label} stages (wall ms, host clock): " + ", ".join(
            f"{k} {v:.1f} total / {len(timer.history[k])} calls / max "
            f"{max(timer.history[k]):.1f}" for k, v in sorted(timer.ms.items()))
            + f"; {card}", flush=True)
    if lc.n_loops_closed < 1:
        fail("the loop circle closed no loop")
    if n_tracked < MIN_LOOP_TRACKED:
        fail(f"the loop circle tracked {n_tracked} of {LOOP_FRAMES} frames "
             f"(< {MIN_LOOP_TRACKED})")
    if not ate < MAX_LOOP_ATE_M:
        fail(f"loop circle ATE {100 * ate:.3f} cm >= {100 * MAX_LOOP_ATE_M:g} cm")
    if slam.tracker.epoch_violations:
        fail(f"{slam.tracker.epoch_violations} pose-epoch violations")
    check_build_launches("the loop circle", launches, LOOP_FRAMES)
    keys = ("sim3_ransac_batch", "optimize_sim3", "optimize_essential_graph",
            "gba_chunk")
    missing = [k for k in keys if k not in captured]
    if missing:
        fail(f"the loop circle never called {missing}")
    solves = {}
    for name in keys:
        f, a, kw = captured[name]
        fn = (lambda f=f, a=a, kw=kw: f(*a, **kw))
        # The essential graph (~3.6 s a call) and OptimizeSim3 (~1.1 s) are
        # timed over one call each and profiled in phase 13 on the long
        # map's inputs instead: every profiled call of theirs costs seconds
        # of host time for 30,000-115,000 records.
        reps = 1 if name in SLOW_SOLVES else 3
        call_ms = cuda_ms(torch, fn, reps=reps)
        d_ms, n_k = ((None, None) if name in SLOW_SOLVES else
                     stage_device_ms(torch, fn, reps=reps, required=False))
        if name == "gba_chunk":
            label = (f"one global-BA chunk ({f.__name__}, "
                     f"{kw['n_iters']} LM iterations)")
            shapes = [tuple(a[0].Tcw.shape), tuple(a[0].points.shape),
                      tuple(a[0].e_cam.shape)]
        else:
            label = name
            shapes = [tuple(x.shape) for x in a
                      if torch.is_tensor(x) and x.dim() >= 2][:2]
        solves[name] = dict(device_ms=d_ms, kernels=n_k, call_ms=call_ms,
                            shapes=shapes, solver=f.__name__)
        if name in SLOW_SOLVES:
            print(f"{label} on the run's inputs {shapes}: call {call_ms:.3f} "
                  f"ms (CUDA events, one call; profiled in phase 13); {card}",
                  flush=True)
            continue
        idle = "not measured" if d_ms is None else f"{1.0 - d_ms / call_ms:.3f}"
        print(f"{label} on the run's inputs {shapes}: {n_k} device kernels, "
              f"{ms_text(d_ms)} summed device time (profiler), call "
              f"{call_ms:.3f} ms (CUDA events), device idle share {idle}; "
              f"{card}", flush=True)
    # The global-BA solver the run did not take (GBA_DENSE_MAX_CAMS picks
    # dense Schur or PCG by keyframe count) on the same chunk, so the two
    # stand side by side at this map's size.
    f, a, kw = captured["gba_chunk"]
    dense, cg = originals["bundle_adjust"], originals["bundle_adjust_cg"]
    if f is dense:
        fn = (lambda: cg(*a, n_iters=kw["n_iters"],
                         cg_iters=loop_closing.GBARunner.CG_ITERS))
    else:
        fn = (lambda: dense(*a, n_iters=kw["n_iters"]))
    other = "bundle_adjust_cg" if f is dense else "bundle_adjust"
    call_ms = cuda_ms(torch, fn, reps=3)
    d_ms, n_k = stage_device_ms(torch, fn, reps=3, required=False)
    solves["gba_chunk_other_solver"] = dict(
        device_ms=d_ms, kernels=n_k, call_ms=call_ms,
        shapes=solves["gba_chunk"]["shapes"], solver=other)
    taken = solves["gba_chunk"]
    print(f"global-BA chunk by solver at {taken['shapes'][0][0]} keyframes "
          f"(GBA_DENSE_MAX_CAMS {loop_closing.GBA_DENSE_MAX_CAMS}): "
          f"{taken['solver']} (taken) {ms_text(taken['device_ms'])} device / "
          f"{taken['call_ms']:.3f} ms call, {other} {ms_text(d_ms)} device / "
          f"{call_ms:.3f} ms call in {n_k} kernels; {card}", flush=True)
    return dict(last_loop=lc.last_loop, n_tracked=n_tracked, ate_cm=100 * ate,
                keyframes=slam.arena.n_keyframes(), points=slam.arena.n_points(),
                gba=gba_when, stats=dict(lc.stats), launches=launches,
                wall_s=wall_s, stage_ms=stage_ms, solves=solves)


def stereo_phase(torch, kernels, check_kernel_b, card) -> dict:
    """Phase 8 (see the module docstring); returns its numbers."""
    from orb_slam_system_tpu_torch.config import (Sensor, TrackingState,
                                                  load_settings)
    from orb_slam_system_tpu_torch.drivers import stereo_synthetic
    from orb_slam_system_tpu_torch.models import frame as frame_mod
    from orb_slam_system_tpu_torch.ops import fast, patches

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_settings(os.path.join(root, "examples", "settings",
                                     "kitti00-02.yaml"), Sensor.STEREO)
    cam = cfg.camera
    captured = []
    original = frame_mod.stereo_match

    def spy(*a, **kw):
        if not captured:
            captured.append((a, kw))
        return original(*a, **kw)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    frame_mod.stereo_match = spy
    t0 = time.perf_counter()
    try:
        slam, ate, span, span_gt = stereo_synthetic.run(
            STEREO_FRAMES, None, device="cuda", verbose=True, cfg=cfg,
            tex_scale=TEX_SCALE)
    finally:
        frame_mod.stereo_match = original
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    recs = slam.telemetry.records
    n_ok = sum(r["state"] == int(TrackingState.OK) for r in recs)
    kf0 = slam.arena.kfs.get(slam.arena.kf_origin_id)
    ur = kf0.feats.u_right if kf0 is not None else np.zeros(0)
    disp = kf0.feats.xy_und[ur >= 0, 0] - ur[ur >= 0] if kf0 is not None else ur
    n_disp = int(((disp > 0) & (disp < cam.fx)).sum())
    track_med = statistics.median(r["track_ms"] for r in recs)
    map_med = statistics.median(r["mapping_ms"] for r in recs)
    print(f"stereo: {STEREO_FRAMES} KITTI 00-02 pairs {cam.width}x{cam.height} "
          f"(bf {cam.bf}, th_depth {cfg.th_depth:.3f} m) in {wall_s:.1f} s; "
          f"initialized at frame {kf0.frame_id if kf0 else None}, {n_ok}/"
          f"{STEREO_FRAMES} frames tracked, {slam.arena.n_keyframes()} "
          f"keyframes, {slam.arena.n_points()} map points; ATE RMSE "
          f"(SE3-aligned) {100 * ate:.3f} cm; metric span {span:.4f} m against "
          f"{span_gt:.4f} m ({100 * (span - span_gt) / span_gt:+.2f}%); keyframe "
          f"0: {int((ur >= 0).sum())} right matches, {n_disp} with 0 < "
          f"disparity < fx, median disparity "
          f"{float(np.median(disp)) if len(disp) else 0.0:.2f} px; track "
          f"median {track_med:.3f} ms, mapping median {map_med:.3f} ms (host "
          f"clock); launches {launches}; {card}", flush=True)
    if kf0 is None or kf0.frame_id != 0:
        fail("stereo: the map was not initialized at frame 0")
    if slam.get_tracking_state() != TrackingState.OK:
        fail(f"stereo ends {slam.get_tracking_state().name}, not OK")
    if not ate < MAX_STEREO_ATE_M:
        fail(f"stereo ATE {100 * ate:.3f} cm >= {100 * MAX_STEREO_ATE_M:g} cm")
    if not abs(span - span_gt) / span_gt < MAX_SPAN_ERR_STEREO:
        fail(f"stereo metric span {span:.4f} m against {span_gt:.4f} m")
    if n_disp <= 150 or n_disp != int((ur >= 0).sum()):
        fail(f"stereo keyframe 0: {n_disp} of {int((ur >= 0).sum())} right "
             f"matches with 0 < disparity < fx (need > 150, all)")
    if n_ok < MIN_TRACKED_SHARE * STEREO_FRAMES:
        fail(f"stereo tracked {n_ok} of {STEREO_FRAMES} frames")
    check_build_launches("stereo", launches, STEREO_FRAMES)
    if not captured:
        fail("the stereo run never called stereo_match")

    # stereo_match on the run's first inputs: wall (host clock around a
    # synchronize), call (CUDA events) and device ms with its kernel count.
    a, kw = captured[0]
    fn = lambda: original(*a, **kw)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t1))
    call_sm = cuda_ms(torch, fn, reps=5)
    dev_sm, n_sm = stage_device_ms(torch, fn, reps=3, required=False)
    idle = "not measured" if dev_sm is None else f"{1.0 - dev_sm / call_sm:.3f}"
    print(f"stereo_match on the run's inputs (2 x {a[2].shape[0]} keypoints, "
          f"8 levels): wall median {statistics.median(walls):.3f} ms, call "
          f"{call_sm:.3f} ms, {n_sm} device kernels, {ms_text(dev_sm)} summed "
          f"device time (profiler), device idle share {idle}; {card}",
          flush=True)

    # Kernels A and B at the pair's batch-2 shape, against their plain
    # versions, and their times there.
    pairs, _ = stereo_synthetic.render_pairs(cfg, 1, TEX_SCALE)
    fb = slam.tracker.builder
    img = torch.stack([fb._upload(pairs[0][0]), fb._upload(pairs[0][1])])
    _, canvas, xy, levels = fb.extractor.detect(img)
    for lvl, k_out in zip(levels, fast.fast_score_nms_levels(levels, 19)):
        if not torch.equal(k_out, fast.nms3x3(fast.fast_score_map(lvl, 19))):
            fail(f"kernel A differs from the plain version on the stereo "
                 f"level {tuple(lvl.shape)}")
    run_a = lambda: fast.fast_score_nms_levels(levels, 19)
    px = sum(l.numel() for l in levels)
    a_shape = dict(
        shape=[tuple(l.shape) for l in levels], launches_per_frame=1,
        ms=cuda_ms(torch, run_a),
        device_ms=device_ms(torch, run_a, "fast_score_nms_kernel"),
        plain_ms=cuda_ms(torch, lambda: [fast.nms3x3(fast.fast_score_map(l, 19))
                                         for l in levels]),
        bound=bound_ms(8.0 * px, 330.0 * px), bytes_ms=bound_ms(8.0 * px, 0.0)[0],
        minmax_ms=1e3 * 106.0 * px / (F32_OPS_PER_S / 4))
    pb, _, mom_err = check_kernel_b(canvas, xy)
    n_read = canvas_floats_read(torch, patches, canvas, xy)
    run_s = lambda: patches.gather_blur_describe(canvas, xy, 21)
    dev_s, n_s = stage_device_ms(torch, run_s)
    b_shape = dict(
        shape=[tuple(canvas.shape), tuple(xy.shape)], launches_per_frame=1,
        ms=cuda_ms(torch, run_s), device_ms=dev_s, kernels=n_s,
        plain_ms=cuda_ms(torch, lambda: patches.gather_blur_describe_plain(
            canvas, xy, 21)),
        bound=describe_bound(n_read, xy, pb.shape[-1]),
        canvas_floats=canvas.numel(), canvas_floats_read=n_read)
    if n_s != 1:
        fail(f"the describe stage launched {n_s} kernels at the stereo shape")
    for label, r in (("kernel A (8 levels of the pair, B = 2)", a_shape),
                     ("kernel B describe mode (2 x 2048 slots)", b_shape)):
        print(f"{label} at the stereo shape {r['shape']}: device "
              f"{r['device_ms']:.5f} ms, call {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]})"
              + (f"; this design's: bytes {r['bytes_ms']:.5f} ms, min/max "
                 f"issue {r['minmax_ms']:.5f} ms" if "bytes_ms" in r else
                 f"; {n_read} of the canvas's {canvas.numel()} floats inside "
                 f"the keypoints' windows") + f"; {card}", flush=True)
    return dict(n_tracked=n_ok, ate_cm=100 * ate, span=span, span_gt=span_gt,
                keyframes=slam.arena.n_keyframes(), points=slam.arena.n_points(),
                kf0_matched=n_disp, wall_s=wall_s, track_median_ms=track_med,
                mapping_median_ms=map_med, launches=launches,
                stereo_match=dict(wall_ms=statistics.median(walls),
                                  call_ms=call_sm, device_ms=dev_sm,
                                  kernels=n_sm),
                kernel_a=a_shape, kernel_b=b_shape, moments_err=mom_err)


def rgbd_phase(torch, kernels, card) -> dict:
    """Phase 9 (see the module docstring); returns its numbers."""
    from orb_slam_system_tpu_torch.config import TrackingState
    from orb_slam_system_tpu_torch.drivers import rgbd_synthetic

    cfg = rgbd_config()
    W, H = cfg.camera.width, cfg.camera.height
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slam, ate, span, span_gt, loc_ok, vo_used = rgbd_synthetic.run(
        RGBD_FRAMES, None, device="cuda", verbose=True, cfg=cfg,
        tex_scale=TEX_SCALE, localize=LOCALIZE_FRAMES)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    recs = slam.telemetry.records
    ok = int(TrackingState.OK)
    n_ok = sum(r["state"] == ok for r in recs[:RGBD_FRAMES])
    kf0 = slam.arena.kfs.get(slam.arena.kf_origin_id)
    d = kf0.feats.depth[kf0.feats.valid] if kf0 is not None else np.zeros(0)
    d = d[d > 0]
    track_med = statistics.median(r["track_ms"] for r in recs)
    map_med = statistics.median(r["mapping_ms"] for r in recs[:RGBD_FRAMES])
    print(f"rgbd: {RGBD_FRAMES} frames {W}x{H} in {wall_s:.1f} s (with "
          f"{LOCALIZE_FRAMES} in localization mode); initialized at frame "
          f"{kf0.frame_id if kf0 else None}, {n_ok}/{RGBD_FRAMES} tracked, "
          f"{slam.arena.n_keyframes()} keyframes, {slam.arena.n_points()} map "
          f"points; ATE RMSE (SE3-aligned) {100 * ate:.3f} cm; metric span "
          f"{span:.4f} m against {span_gt:.4f} m "
          f"({100 * (span - span_gt) / span_gt:+.2f}%); keyframe 0 depths "
          f"{float(d.min()) if len(d) else 0.0:.3f}-"
          f"{float(d.max()) if len(d) else 0.0:.3f} m; localization mode: "
          f"frames OK {loc_ok}, VO points used {vo_used}, VO points on the "
          f"last frame {len(slam.tracker.current.vo_points or ())}, mb_vo "
          f"{slam.tracker.mb_vo}; track median {track_med:.3f} ms, mapping "
          f"median {map_med:.3f} ms (host clock); launches {launches}; {card}",
          flush=True)
    if n_ok < RGBD_FRAMES - 2:
        fail(f"rgbd tracked {n_ok} of {RGBD_FRAMES} frames")
    if not ate < MAX_RGBD_ATE_M:
        fail(f"rgbd ATE {100 * ate:.3f} cm >= {100 * MAX_RGBD_ATE_M:g} cm")
    if not abs(span - span_gt) / span_gt < MAX_SPAN_ERR_RGBD:
        fail(f"rgbd metric span {span:.4f} m against {span_gt:.4f} m")
    if slam.arena.n_points() <= 200:
        fail(f"rgbd map has {slam.arena.n_points()} points (need > 200)")
    if kf0 is None or not len(d) or not ((d > 1.0) & (d < 10.0)).all():
        fail("rgbd keyframe 0's depths are not all inside (1, 10) m")
    if not (loc_ok[0] and loc_ok[-1] and vo_used):
        fail(f"localization mode: frames OK {loc_ok}, VO points used "
             f"{vo_used} (need the first and the last OK, on VO points)")
    n_frames = RGBD_FRAMES + LOCALIZE_FRAMES
    check_build_launches("rgbd", launches, n_frames)
    return dict(n_tracked=n_ok, ate_cm=100 * ate, span=span, span_gt=span_gt,
                keyframes=slam.arena.n_keyframes(), points=slam.arena.n_points(),
                localization_ok=loc_ok, vo_used=vo_used, wall_s=wall_s,
                track_median_ms=track_med, mapping_median_ms=map_med,
                launches=launches)


def memoize_renders(synthetic) -> dict:
    """Serve PlanarSceneRenderer.render from a cache keyed on the texture,
    the camera and the pose, and return the cache. Later phases render poses
    of earlier ones again (10b phase 7's circle, 10c phase 8's pairs, phase
    11 those of 10a, 9 and 8), each render a minute's share of host time
    on the card's machine; a hit is a copy of the same image."""
    cls = synthetic.PlanarSceneRenderer
    orig = cls.render
    cache: dict = {}

    def render(self, Tcw):
        tex = getattr(self, "_tex_key", None)
        if tex is None or tex[0] is not self.texture:
            digest = hashlib.sha1(np.ascontiguousarray(self.texture)).hexdigest()
            tex = self._tex_key = (self.texture, digest)
        T = np.asarray(Tcw)
        key = (tex[1], self.K.tobytes(), self.width, self.height,
               self.tex_scale, self.supersample, T.dtype.str, T.tobytes())
        if key not in cache:
            cache[key] = orig(self, Tcw)
        return cache[key].copy()
    cls.render = render
    return cache


class BuildCount:
    """Counts frame builds while active (FrameBuilder._frame runs once per
    build, whichever builder and sensor)."""

    def __init__(self, frame_mod):
        self.n = 0
        self._cls = frame_mod.FrameBuilder
        self._orig = None

    def __enter__(self):
        orig = self._orig = self._cls._frame

        def counted(builder, packed, timestamp):
            self.n += 1
            return orig(builder, packed, timestamp)
        self._cls._frame = counted
        return self

    def __exit__(self, *exc):
        self._cls._frame = self._orig


def check_build_launches(label: str, launches: dict, n_builds: int) -> None:
    """Kernel A and B's describe mode once per frame build, the unfused
    route's kernels never."""
    for name, want in (("fast_score_nms", n_builds),
                       ("gather_blur_describe", n_builds), ("brief_pack", 0),
                       ("gather_blur_moments", 0), ("gather_patches", 0)):
        if launches[name] != want:
            fail(f"{label}: kernel {name} launched {launches[name]} times for "
                 f"{n_builds} frame builds, not {want}")


def stage_medians(timer) -> dict:
    """Median ms of each stage of a StageTimer."""
    return {k: round(statistics.median(v), 3)
            for k, v in sorted(timer.history.items()) if v}


def realtime_phase(torch, kernels, card, classic_frame_ms: float) -> dict:
    """Phase 10 (see the module docstring); returns its numbers.
    classic_frame_ms: phase 5's median ms per frame (track + mapping)."""
    from orb_slam_system_tpu_torch.config import (Sensor, TrackingState,
                                                  load_settings)
    from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
    from orb_slam_system_tpu_torch.drivers import (loop_synthetic,
                                                   mono_synthetic,
                                                   stereo_synthetic)
    from orb_slam_system_tpu_torch.models import frame as frame_mod
    from orb_slam_system_tpu_torch.models.system import System
    from orb_slam_system_tpu_torch.models.track_device import ChainFetch

    t_phase = time.perf_counter()
    OK = TrackingState.OK
    W, H = 640, 480
    cfg = mono_synthetic.make_config(W, H, 1000)
    frames, poses = mono_synthetic.render_sequence(cfg, REALTIME_FRAMES)
    frames, poses = frames[:REALTIME_RUN], poses[:REALTIME_RUN]
    frames = [np.clip(f, 0, 255).astype(np.uint8) for f in frames]
    gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
          for i, T in enumerate(poses)}
    n_warm = REALTIME_CLASSIC + REALTIME_WARM
    n_timed = REALTIME_RUN - n_warm

    def items(lo, hi):
        return ((frames[i], i / 30.0) for i in range(lo, hi))

    def ate(slam):
        return traj_io.ate_rmse(
            traj_io.frame_poses(slam.arena, slam.tracker.trajectory), gt)

    def timed(it, slam):
        """(seconds, frames OK) over the frames `it` yields."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_ok = 0
        for _ in it:
            n_ok += slam.get_tracking_state() == OK
        torch.cuda.synchronize()
        return time.perf_counter() - t0, n_ok

    def check_mono(label, slam, n_ok, err):
        if n_ok < MIN_TRACKED_SHARE * n_timed:
            fail(f"{label}: {n_ok} of the {n_timed} timed frames OK")
        if slam.get_tracking_state() != OK:
            fail(f"{label} ends {slam.get_tracking_state().name}, not OK")
        if not err < MAX_ATE_M:
            fail(f"{label} ATE {100 * err:.3f} cm >= {100 * MAX_ATE_M:g} cm")

    def track_ms(recs):
        return round(statistics.median(r["track_ms"] for r in recs), 3)

    # 10a: the pipelined mode with the async mapper.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with BuildCount(frame_mod) as builds:
        slam = System(cfg, device="cuda", async_mapping=True)
        for i in range(REALTIME_CLASSIC):
            slam.track_monocular(frames[i], i / 30.0)
        for _ in slam.track_monocular_pipelined(
                items(REALTIME_CLASSIC, n_warm), depth=2):
            pass
        dt, n_ok = timed(slam.track_monocular_pipelined(
            items(n_warm, REALTIME_RUN), depth=2), slam)
        slam.shutdown()
    launches = dict(kernels.LAUNCHES)
    tr = slam.tracker
    recs = slam.telemetry.records
    err = ate(slam)
    mono = dict(
        fps=n_timed / dt, wall_ms_per_frame=1e3 * dt / n_timed,
        frames_ok=n_ok, ate_cm=100 * err, keyframes=slam.arena.n_keyframes(),
        points=slam.arena.n_points(), chain_stats=dict(tr.chain_stats),
        kf_wait_stats=dict(tr.kf_wait_stats),
        worker_errors=slam.local_mapper.worker_errors,
        track_ms_classic=track_ms(recs[:REALTIME_CLASSIC]),
        track_ms_pipelined=track_ms(recs[n_warm:]),
        tracking_stage_ms=stage_medians(tr.stage_ms),
        mapping_stage_ms=stage_medians(slam.local_mapper.stage_ms),
        builds=builds.n, launches=launches)
    print(f"realtime 10a pipelined: {n_timed} frames {W}x{H} in {dt:.2f} s = "
          f"{mono['fps']:.3f} fps ({mono['wall_ms_per_frame']:.1f} ms a frame, "
          f"depth 2, async mapper); {n_ok}/{n_timed} OK, ATE {100 * err:.3f} "
          f"cm, {mono['keyframes']} keyframes, {mono['points']} points; "
          f"chain_stats {mono['chain_stats']}; kf_wait_stats "
          f"{mono['kf_wait_stats']}; worker errors {mono['worker_errors']}; "
          f"track ms median classic {mono['track_ms_classic']}, pipelined "
          f"{mono['track_ms_pipelined']} (the frame's bookkeeping after its "
          f"event wait); {builds.n} builds, launches {launches}; {card}",
          flush=True)
    print(f"realtime 10a tracking stages (median ms): "
          f"{mono['tracking_stage_ms']}", flush=True)
    print(f"realtime 10a mapping stages (median ms): "
          f"{mono['mapping_stage_ms']}", flush=True)
    check_mono("pipelined", slam, n_ok, err)
    if tr.chain_stats["accept"] < 1:
        fail(f"the chain accepted no frame: {tr.chain_stats}")
    if slam.local_mapper.worker_errors:
        fail(f"{slam.local_mapper.worker_errors} mapping worker errors")
    check_build_launches("realtime 10a pipelined", launches, builds.n)

    # One chain step on the finished map, from enqueue to its event wait.
    with slam._lock, slam.arena.correction_lock, slam.arena.lock:
        state, ids = tr.chain_bootstrap()
    frame = tr.builder.build(frames[-1], REALTIME_FRAMES / 30.0)
    fetch = ChainFetch(tr.programs.chain_out_size, 2, "cuda")

    def chain_step():
        out = tr.chain_enqueue(frame, state, tr.last_frame.packed, ids)[2]
        return ChainFetch.wait(fetch.issue(out))
    chain_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain_step()
    wall = 1e3 * (time.perf_counter() - t0)
    prof = profile_device(torch, "one chain step (enqueue to the event wait, "
                          "1024 slots, 4096-point block)", chain_step, wall)
    if prof is not None:
        mono["chain_step"] = dict(kernels=prof[0], device_ms=prof[1],
                                  wall_ms=prof[2],
                                  idle_share=1.0 - prof[1] / prof[2])

    # 10a: the stream mode, on a fresh async System.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with BuildCount(frame_mod) as builds_s:
        slam_s = System(cfg, device="cuda", async_mapping=True)
        for i in range(n_warm):
            slam_s.track_monocular(frames[i], i / 30.0)
        dt_s, n_ok_s = timed(slam_s.track_monocular_stream(
            items(n_warm, REALTIME_RUN)), slam_s)
        slam_s.shutdown()
    launches_s = dict(kernels.LAUNCHES)
    err_s = ate(slam_s)
    recs_s = slam_s.telemetry.records
    stream = dict(fps=n_timed / dt_s, wall_ms_per_frame=1e3 * dt_s / n_timed,
                  frames_ok=n_ok_s, ate_cm=100 * err_s,
                  track_ms=track_ms(recs_s[n_warm:]),
                  kf_wait_stats=dict(slam_s.tracker.kf_wait_stats),
                  classic_phase5_ms_per_frame=classic_frame_ms,
                  builds=builds_s.n, launches=launches_s)
    print(f"realtime 10a stream: {n_timed} frames in {dt_s:.2f} s = "
          f"{stream['fps']:.3f} fps ({stream['wall_ms_per_frame']:.1f} ms a "
          f"frame, async mapper) against phase 5's classic synchronous "
          f"{classic_frame_ms:.1f} ms a frame ({1e3 / classic_frame_ms:.3f} "
          f"fps); {n_ok_s}/{n_timed} OK, ATE {100 * err_s:.3f} cm; track ms "
          f"median {stream['track_ms']}; kf_wait_stats "
          f"{stream['kf_wait_stats']}; {builds_s.n} builds, launches "
          f"{launches_s}; {card}", flush=True)
    check_mono("stream", slam_s, n_ok_s, err_s)
    check_build_launches("realtime 10a stream", launches_s, builds_s.n)

    # 10b: the loop circle through the chain.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with BuildCount(frame_mod) as builds_l:
        slam_l, ate_l, n_tracked = loop_synthetic.run(
            LOOP_FRAMES, None, 1000, W, H, device="cuda", verbose=True,
            pipelined=True)
    torch.cuda.synchronize()
    launches_l = dict(kernels.LAUNCHES)
    lc = slam_l.loop_closer
    loop = dict(loops=lc.n_loops_closed, last_loop=lc.last_loop,
                n_tracked=n_tracked, ate_cm=100 * ate_l,
                epoch_violations=slam_l.tracker.epoch_violations,
                pose_epoch=slam_l.arena.pose_epoch,
                gba_applied=lc.n_gba_applied,
                chain_stats=dict(slam_l.tracker.chain_stats),
                wall_s=time.perf_counter() - t0, builds=builds_l.n,
                launches=launches_l)
    print(f"realtime 10b loop circle through the chain: {LOOP_FRAMES} frames "
          f"in {loop['wall_s']:.1f} s; loops closed {loop['loops']} (last "
          f"{loop['last_loop']}); {n_tracked}/{LOOP_FRAMES} tracked; ATE "
          f"{100 * ate_l:.3f} cm; pose epoch {loop['pose_epoch']}, epoch "
          f"violations {loop['epoch_violations']}; global BAs applied "
          f"{loop['gba_applied']}; chain_stats {loop['chain_stats']}; "
          f"{builds_l.n} builds, launches {launches_l}; {card}", flush=True)
    if lc.n_loops_closed < 1:
        fail("the pipelined loop circle closed no loop")
    if n_tracked < MIN_LOOP_TRACKED:
        fail(f"the pipelined loop circle tracked {n_tracked} of {LOOP_FRAMES}")
    if not ate_l < MAX_LOOP_ATE_M:
        fail(f"pipelined loop ATE {100 * ate_l:.3f} cm >= "
             f"{100 * MAX_LOOP_ATE_M:g} cm")
    if slam_l.tracker.epoch_violations:
        fail("pose-epoch violation in the pipelined loop circle")
    check_build_launches("realtime 10b loop", launches_l, builds_l.n)

    # 10c: KITTI-width stereo through the chain.
    root = os.path.dirname(os.path.abspath(__file__))
    cfg_st = load_settings(os.path.join(root, "examples", "settings",
                                        "kitti00-02.yaml"), Sensor.STEREO)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with BuildCount(frame_mod) as builds_st:
        slam_st, ate_st, span, span_gt = stereo_synthetic.run(
            REALTIME_STEREO, None, device="cuda", verbose=True, cfg=cfg_st,
            tex_scale=TEX_SCALE, pipelined=True)
    torch.cuda.synchronize()
    launches_st = dict(kernels.LAUNCHES)
    recs_st = slam_st.telemetry.records
    n_ok_st = sum(r["state"] == int(OK) for r in recs_st)
    kf0 = slam_st.arena.kfs.get(slam_st.arena.kf_origin_id)
    stereo = dict(n_ok=n_ok_st, ate_cm=100 * ate_st, span=span,
                  span_gt=span_gt, keyframes=slam_st.arena.n_keyframes(),
                  init_frame=None if kf0 is None else kf0.frame_id,
                  chain_stats=dict(slam_st.tracker.chain_stats),
                  track_ms=track_ms(recs_st), wall_s=time.perf_counter() - t0,
                  builds=builds_st.n, launches=launches_st)
    print(f"realtime 10c stereo through the chain: {REALTIME_STEREO} KITTI "
          f"pairs in {stereo['wall_s']:.1f} s; initialized at frame "
          f"{stereo['init_frame']}, {n_ok_st}/{REALTIME_STEREO} OK, ATE "
          f"(SE3-aligned) {100 * ate_st:.3f} cm, span {span:.4f} m against "
          f"{span_gt:.4f} m, {stereo['keyframes']} keyframes; chain_stats "
          f"{stereo['chain_stats']}; track ms median {stereo['track_ms']}; "
          f"{builds_st.n} builds, launches {launches_st}; {card}", flush=True)
    if stereo["init_frame"] != 0:
        fail(f"pipelined stereo initialized at frame {stereo['init_frame']}")
    if n_ok_st < MIN_TRACKED_SHARE * REALTIME_STEREO:
        fail(f"pipelined stereo tracked {n_ok_st} of {REALTIME_STEREO}")
    if not ate_st < MAX_STEREO_ATE_M:
        fail(f"pipelined stereo ATE {100 * ate_st:.3f} cm")
    if slam_st.tracker.chain_stats["accept"] < 1:
        fail(f"the stereo chain never engaged: {stereo['chain_stats']}")
    check_build_launches("realtime 10c stereo", launches_st, builds_st.n)
    wall_s = time.perf_counter() - t_phase
    print(f"phase 10 in {wall_s:.1f} s", flush=True)
    return dict(mono=mono, stream=stream, loop=loop, stereo=stereo,
                wall_s=wall_s)


class FetchTimer:
    """Host ms of each PrefetchLoader.fetch while active: how long the
    driver waited for a decoded frame."""

    def __init__(self, native):
        self.ms = []
        self._cls = native.PrefetchLoader
        self._orig = None

    def __enter__(self):
        orig = self._orig = self._cls.fetch

        def timed(loader, idx):
            t0 = time.perf_counter()
            out = orig(loader, idx)
            self.ms.append(1e3 * (time.perf_counter() - t0))
            return out
        self._cls.fetch = timed
        return self

    def __exit__(self, *exc):
        self._cls.fetch = self._orig


def sequences_phase(torch, kernels, card) -> dict:
    """Phase 11 (see the module docstring); returns its numbers."""
    import contextlib
    import io
    import re

    from orb_slam_system_tpu_torch import native
    from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig,
                                                  Sensor, SlamConfig,
                                                  TrackingState, load_settings,
                                                  save_settings_yaml)
    from orb_slam_system_tpu_torch.dataio import layouts
    from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu_torch.drivers import (mono_euroc, mono_synthetic,
                                                   mono_tum, rgbd_synthetic,
                                                   rgbd_tum, run_dataset,
                                                   stereo_kitti)
    from orb_slam_system_tpu_torch.models import frame as frame_mod
    from orb_slam_system_tpu_torch.models.system import System
    from orb_slam_system_tpu_torch.vocab.vocabulary import generate_orbvoc

    t_phase = time.perf_counter()
    OK = int(TrackingState.OK)

    # 11a: the native decoder.
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    if gxx.returncode != 0:
        fail(f"g++ --version failed: {gxx.stderr.strip()}")
    t0 = time.perf_counter()
    lib_path = native.build()
    native.library()
    nat = dict(gxx=gxx.stdout.splitlines()[0],
               build_s=time.perf_counter() - t0, library=str(lib_path))
    print(f"native decoder: {nat['gxx']}; built {lib_path} in "
          f"{nat['build_s']:.1f} s", flush=True)

    def u8(img):
        return np.clip(img, 0, 255).astype(np.uint8)

    root_dir = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_seq_")
    root = tmp.name
    t0 = time.perf_counter()
    # 11b: TUM mono, the first frames of 10a's u8 orbit (its renderer:
    # mono_synthetic.make_renderer at 640x480).
    texture = make_texture(2048, 8, 7)
    cfg_m = mono_synthetic.make_config(640, 480, 1000)
    poses_m = orbit_trajectory(REALTIME_FRAMES, radius=0.35, depth=-2.0,
                               tilt=0.3)[:SEQ_TUM_FRAMES]
    r_m = PlanarSceneRenderer(cfg_m.camera.K, 640, 480, texture=texture,
                              tex_scale=TEX_SCALE)
    frames_m = [u8(r_m.render(T)) for T in poses_m]
    tum = os.path.join(root, "tum_mono")
    layouts.write_tum(tum, frames_m, [i / 30.0 for i in range(SEQ_TUM_FRAMES)],
                      poses_m)
    save_settings_yaml(cfg_m, os.path.join(root, "tum_mono.yaml"))
    voc = os.path.join(root, "voc_k10_L2.txt")
    generate_orbvoc(voc, k=10, L=2, seed=0)
    # TUM RGB-D: phase 9's camera and orbit, depth x 5000 in 16-bit PNGs.
    cam_d = CameraConfig(fx=520.0, fy=520.0, cx=320.0, cy=240.0, fps=30.0,
                         width=640, height=480, bf=40.0)
    cfg_d = SlamConfig(camera=cam_d, orb=ORBConfig(n_features=1000),
                       sensor=Sensor.RGBD, th_depth=40.0 * 40.0 / 520.0,
                       depth_map_factor=rgbd_synthetic.DEPTH_MAP_FACTOR)
    r_d = PlanarSceneRenderer(cam_d.K, 640, 480, texture=texture,
                              tex_scale=TEX_SCALE)
    poses_d = orbit_trajectory(RGBD_FRAMES + LOCALIZE_FRAMES, radius=0.35,
                               depth=-2.0, tilt=0.3)[:SEQ_FRAMES]
    rgbd = os.path.join(root, "tum_rgbd")
    layouts.write_tum(
        rgbd, [u8(r_d.render(T)) for T in poses_d],
        [i / 30.0 for i in range(SEQ_FRAMES)], poses_d,
        [np.round(r_d.render_depth(T) * cfg_d.depth_map_factor)
         .astype(np.uint16) for T in poses_d])
    save_settings_yaml(cfg_d, os.path.join(root, "tum_rgbd.yaml"))
    # KITTI stereo: phase 8's first pairs at KITTI 00-02's settings (as
    # stereo_synthetic.render_pairs makes them).
    cfg_k = load_settings(os.path.join(root_dir, "examples", "settings",
                                       "kitti00-02.yaml"), Sensor.STEREO)
    cam_k = cfg_k.camera
    r_k = PlanarSceneRenderer(cam_k.K, cam_k.width, cam_k.height,
                              texture=texture, tex_scale=TEX_SCALE)
    poses_k = orbit_trajectory(STEREO_FRAMES, radius=0.35, depth=-2.0,
                               tilt=0.3)[:SEQ_FRAMES]
    pairs = [r_k.render_stereo(T, cam_k.bf / cam_k.fx) for T in poses_k]
    kitti = os.path.join(root, "kitti_00")
    kitti_gt = layouts.write_kitti(
        kitti, [u8(p[0]) for p in pairs], [0.1 * i for i in range(SEQ_FRAMES)],
        poses_k, [u8(p[1]) for p in pairs])
    # EuRoC mono: cam0's intrinsics, no distortion, 20 Hz.
    fx, fy, cx, cy = EUROC_K
    cam_e = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, fps=20.0, width=EUROC_W,
                         height=EUROC_H)
    cfg_e = SlamConfig(camera=cam_e, orb=ORBConfig(n_features=1000),
                       sensor=Sensor.MONOCULAR)
    r_e = PlanarSceneRenderer(cam_e.K, EUROC_W, EUROC_H, texture=texture,
                              tex_scale=TEX_SCALE)
    poses_e = orbit_trajectory(SYSTEM_FRAMES, radius=0.35, depth=-2.0,
                               tilt=0.3)[:SEQ_FRAMES]
    euroc = os.path.join(root, "MH_synthetic")
    euroc_ts = layouts.write_euroc(
        euroc, [u8(r_e.render(T)) for T in poses_e],
        [1403636579763555584 + 50_000_000 * i for i in range(SEQ_FRAMES)],
        poses_e)
    save_settings_yaml(cfg_e, os.path.join(root, "euroc_mono.yaml"))
    print(f"sequences written in {time.perf_counter() - t0:.1f} s (PNG: 8-bit "
          f"frames, 16-bit depth) under {root}", flush=True)

    # 11c: each sequence through run_dataset, in this process.
    def run(label, module, argv, n_frames):
        """(System, ATE m, run numbers) of run_dataset.main(argv), whose
        driver `module` makes one System; fails the run on a nonzero exit."""
        made = []

        def make(*a, **kw):
            made.append(System(*a, **kw))
            return made[-1]
        buf = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        module.System = make
        t0 = time.perf_counter()
        try:
            with BuildCount(frame_mod) as builds, FetchTimer(native) as fetches, \
                    contextlib.redirect_stdout(buf):
                rc = run_dataset.main(argv + [
                    "--device", "cuda", "--out-dir", os.path.join(root, label)])
        finally:
            module.System = System
            out = buf.getvalue()
            print("".join(f"  {label}| {line}\n" for line in out.splitlines()),
                  end="", flush=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if rc != 0 or len(made) != 1:
            fail(f"{label}: run_dataset exited {rc} ({len(made)} Systems)")
        m = re.search(r"absolute_translational_error\.rmse (\S+)", out)
        if m is None or "gate PASS" not in out:
            fail(f"{label}: no ATE gate passed")
        slam = made[0]
        recs = slam.telemetry.records
        states = [r["state"] for r in recs]
        init = next((i for i, st in enumerate(states) if st == OK), None)
        res = dict(frames=len(recs), builds=builds.n, launches=launches,
                   tracked=sum(st == OK for st in states), init_frame=init,
                   tracked_after_init=(sum(st == OK for st in states[init + 1:])
                                       / max(len(states) - init - 1, 1)
                                       if init is not None else 0.0),
                   keyframes=slam.arena.n_keyframes(),
                   points=slam.arena.n_points(), ate_cm=100 * float(m.group(1)),
                   wall_s=wall_s,
                   track_ms_median=statistics.median(r["track_ms"] for r in recs),
                   fetch_ms_median=statistics.median(fetches.ms),
                   fetch_ms_max=max(fetches.ms), fetches=len(fetches.ms))
        print(f"{label}: {res['frames']} frames read and tracked in "
              f"{wall_s:.1f} s; initialized at frame {init}, {res['tracked']}/"
              f"{n_frames} OK ({100 * res['tracked_after_init']:.1f}% after "
              f"initialization), {res['keyframes']} keyframes, {res['points']} "
              f"points; ATE {res['ate_cm']:.3f} cm; track median "
              f"{res['track_ms_median']:.3f} ms, wait on the prefetch ring "
              f"median {res['fetch_ms_median']:.3f} ms, max "
              f"{res['fetch_ms_max']:.3f} ms over {res['fetches']} fetches; "
              f"{builds.n} builds, launches {launches}; {card}", flush=True)
        if res["frames"] != n_frames or f"Images in the sequence: {n_frames}" not in out:
            fail(f"{label}: {res['frames']} frames tracked of {n_frames}")
        check_build_launches(label, launches, builds.n)
        return slam, res

    runs = {}
    slam_m, runs["tum_mono"] = run(
        "tum_mono", mono_tum,
        [tum, "--voc", voc, "--settings", os.path.join(root, "tum_mono.yaml"),
         "--max-ate", str(MAX_ATE_M)], SEQ_TUM_FRAMES)
    r = runs["tum_mono"]
    if slam_m.get_tracking_state() != TrackingState.OK:
        fail(f"tum_mono ends {slam_m.get_tracking_state().name}")
    if r["keyframes"] < 3 or r["points"] <= 150:
        fail(f"tum_mono map: {r['keyframes']} keyframes, {r['points']} points")
    _, runs["tum_rgbd"] = run(
        "tum_rgbd", rgbd_tum,
        [rgbd, "--settings", os.path.join(root, "tum_rgbd.yaml"),
         "--max-ate", str(MAX_RGBD_ATE_M)], SEQ_FRAMES)
    if runs["tum_rgbd"]["tracked"] < SEQ_FRAMES - 2:
        fail(f"tum_rgbd tracked {runs['tum_rgbd']['tracked']} of {SEQ_FRAMES}")
    _, runs["kitti_stereo"] = run(
        "kitti_stereo", stereo_kitti,
        [kitti, "--sensor", "stereo", "--gt", kitti_gt,
         "--max-ate", str(MAX_STEREO_ATE_M)], SEQ_FRAMES)
    if runs["kitti_stereo"]["tracked"] < MIN_TRACKED_SHARE * SEQ_FRAMES:
        fail(f"kitti_stereo tracked {runs['kitti_stereo']['tracked']}")
    _, runs["euroc_mono"] = run(
        "euroc_mono", mono_euroc,
        [euroc, "--timestamps", euroc_ts, "--settings",
         os.path.join(root, "euroc_mono.yaml"), "--max-ate", str(MAX_ATE_M)],
        SEQ_FRAMES)
    if runs["euroc_mono"]["tracked_after_init"] < MIN_TRACKED_SHARE:
        fail(f"euroc_mono tracked {runs['euroc_mono']['tracked_after_init']:.2f}"
             f" of the frames after initialization")

    # 11d: the TUM run's map saved, loaded into a fresh System, then into
    # the run's own.
    map_path = os.path.join(root, "tum_mono_map.npz")
    t0 = time.perf_counter()
    slam_m.save_map(map_path)
    save_ms = 1e3 * (time.perf_counter() - t0)
    n_bytes = os.path.getsize(map_path)
    fp = [(int(round(ts * 30.0)), T) for ts, T, lost in
          traj_io.frame_poses(slam_m.arena, slam_m.tracker.trajectory)
          if not lost]
    tracked_T = dict(fp)
    if MAP_FRAME not in tracked_T:
        fail(f"the TUM run did not track frame {MAP_FRAME}")
    P = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in fp])
    Q = np.stack([-poses_m[i][:3, :3].T @ poses_m[i][:3, 3] for i, _ in fp])
    Pa = traj_io.umeyama_align(P, Q)
    m_per_unit = float(np.sqrt(((Pa - Pa.mean(0)) ** 2).sum()
                               / ((P - P.mean(0)) ** 2).sum()))
    n_kf = slam_m.arena.n_keyframes()
    fresh = System(cfg_m, device="cuda", vocabulary_path=voc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load_map(map_path, localization_only=True)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    kernels.reset_launch_counts()
    with BuildCount(frame_mod) as builds:
        t0 = time.perf_counter()
        T_fresh = fresh.track_monocular(frames_m[MAP_FRAME], 100.0)
        torch.cuda.synchronize()
        reloc_ms = 1e3 * (time.perf_counter() - t0)
        more = [fresh.track_monocular(frames_m[i], 100.0 + i) is not None
                and fresh.get_tracking_state() == TrackingState.OK
                for i in range(MAP_FRAME + 1, MAP_FRAME + 1 + MAP_MORE_FRAMES)]
    torch.cuda.synchronize()
    map_launches = dict(kernels.LAUNCHES)
    ok_fresh = T_fresh is not None and all(more)
    err_m = (float(np.linalg.norm(-T_fresh[:3, :3].T @ T_fresh[:3, 3]
                                  + tracked_T[MAP_FRAME][:3, :3].T
                                  @ tracked_T[MAP_FRAME][:3, 3])) * m_per_unit
             if T_fresh is not None else float("inf"))
    slam_m.load_map(map_path)
    T_used = slam_m.track_monocular(frames_m[MAP_FRAME], 100.0)
    diff = (float(np.abs(T_used - T_fresh).max())
            if T_used is not None and T_fresh is not None else float("inf"))
    maps = dict(bytes=n_bytes, keyframes=n_kf, points=slam_m.arena.n_points(),
                bytes_per_keyframe=n_bytes / max(n_kf, 1), save_ms=save_ms,
                load_ms=load_ms, reloc_ms=reloc_ms, reloc_err_cm=100 * err_m,
                more_ok=more, keyframes_after=fresh.arena.n_keyframes(),
                used_vs_fresh_max_abs=diff, reloc_stats=dict(fresh.tracker.reloc_stats),
                builds=builds.n, launches=map_launches)
    print(f"map: {n_bytes} bytes for {n_kf} keyframes and {maps['points']} "
          f"points ({maps['bytes_per_keyframe']:.0f} bytes a keyframe); save "
          f"{save_ms:.1f} ms, load into a fresh System {load_ms:.1f} ms (file, "
          f"swap, BoW index); frame {MAP_FRAME}'s view relocalized in "
          f"{reloc_ms:.1f} ms, camera centre {100 * err_m:.3f} cm from the "
          f"tracked pose; {MAP_MORE_FRAMES} more frames OK {more}, keyframes "
          f"{maps['keyframes_after']} (were {n_kf}); loaded into the run's "
          f"own System: first pose max |diff| {diff:.3g} against the fresh "
          f"System's; {builds.n} builds, launches {map_launches}; {card}",
          flush=True)
    if not ok_fresh:
        fail(f"localization on the loaded map: first pose {T_fresh is not None}"
             f", later frames OK {more}")
    if not err_m < MAX_RELOC_ERR_M:
        fail(f"relocalized {100 * err_m:.3f} cm from the tracked pose")
    if maps["keyframes_after"] != n_kf:
        fail(f"localization mode added keyframes: {maps['keyframes_after']}")
    if not diff <= MAX_LOAD_DIFF:
        fail(f"a load into the used System differs from a fresh one by {diff}")
    check_build_launches("map localization", map_launches, builds.n)

    # 11e: decode ms per frame against track ms per frame.
    paths = [os.path.join(tum, "rgb", f"{i / 30.0:.6f}.png")
             for i in range(SEQ_TUM_FRAMES)]
    t0 = time.perf_counter()
    for p in paths:
        native.decode_gray(p)
    one_shot = 1e3 * (time.perf_counter() - t0) / len(paths)
    t0 = time.perf_counter()
    with native.PrefetchLoader(paths) as ring:
        for i in range(len(paths)):
            ring.fetch(i)
    ring_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    decode = dict(one_shot_ms=one_shot, ring_ms=ring_ms,
                  waits_ms={k: v["fetch_ms_median"] for k, v in runs.items()},
                  track_ms={k: v["track_ms_median"] for k, v in runs.items()})
    print(f"decode ms per 640x480 PNG frame: one-shot {one_shot:.3f}, through "
          f"the prefetch ring with no consumer work {ring_ms:.3f}; the drivers' "
          f"median wait on the ring {decode['waits_ms']} against their track "
          f"median {decode['track_ms']} (host clock); {card}", flush=True)
    tmp.cleanup()
    wall_s = time.perf_counter() - t_phase
    print(f"phase 11 in {wall_s:.1f} s", flush=True)
    return dict(native=nat, runs=runs, map=maps, decode=decode, wall_s=wall_s)


def multiseq_phase(torch, kernels, check_kernel_b, card) -> dict:
    """Phase 12 (see the module docstring); returns its numbers."""
    import dataclasses

    from orb_slam_system_tpu_torch.config import (ORBConfig, Sensor,
                                                  TrackingState, load_settings)
    from orb_slam_system_tpu_torch.drivers import multiseq_throughput
    from orb_slam_system_tpu_torch.models import frame as frame_mod
    from orb_slam_system_tpu_torch.ops import fast, patches
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
    from orb_slam_system_tpu_torch.parallel import multi_system, multiseq

    t_phase = time.perf_counter()
    OK = int(TrackingState.OK)
    S = MULTISEQ_SEQS
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_settings(os.path.join(root, "orb_slam_system_tpu_torch",
                                     "settings", "euroc_mono.yaml"),
                        Sensor.MONOCULAR)
    if cfg.orb != ORBConfig(n_features=cfg.orb.n_features):
        fail(f"euroc_mono.yaml's extractor is not run_full's: {cfg.orb}")
    # The renderer is a pinhole: cam0's intrinsics without its distortion.
    cam = dataclasses.replace(cfg.camera, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
                              k3=0.0)

    # 12a: S full Systems through MultiSystem.track_batch; per round, the
    # steady sequences and the batched extractions it made.
    rounds = []
    orig_track = multi_system.MultiSystem.track_batch
    orig_extract = frame_mod.FrameBuilder.extract_packed_batch
    n_batch = [0]
    kept = {}

    def track_batch(self, imgs, ts):
        n0 = n_batch[0]
        steady = sum(sy.tracker.state not in (TrackingState.NO_IMAGES_YET,
                                              TrackingState.NOT_INITIALIZED)
                     for sy in self.systems)
        if steady == S and "imgs" not in kept:
            kept["imgs"] = imgs
        poses = orig_track(self, imgs, ts)
        rounds.append((steady, n_batch[0] - n0))
        return poses

    def extract(self, imgs):
        n_batch[0] += 1
        return orig_extract(self, imgs)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    multi_system.MultiSystem.track_batch = track_batch
    frame_mod.FrameBuilder.extract_packed_batch = extract
    t0 = time.perf_counter()
    try:
        with BuildCount(frame_mod) as builds, \
                tempfile.TemporaryDirectory() as out_dir:
            ms, ates, fps = multiseq_throughput.run_full(
                S, MULTISEQ_FRAMES, out_dir, cfg.orb.n_features, verbose=True,
                device="cuda", camera=cam)
            traj_lines = [len(open(os.path.join(
                out_dir, f"CameraTrajectory_seq{s}.txt")).readlines())
                for s in range(S)]
    finally:
        multi_system.MultiSystem.track_batch = orig_track
        frame_mod.FrameBuilder.extract_packed_batch = orig_extract
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steady_rounds = sum(1 for st, _ in rounds if st)
    seqs = []
    for s, sy in enumerate(ms.systems):
        recs = sy.telemetry.records
        states = [r["state"] for r in recs]
        init_at = states.index(OK) if OK in states else None
        post = states[init_at + 1:] if init_at is not None else []
        seqs.append(dict(
            init_at=init_at, final=sy.get_tracking_state().name,
            tracked_after_init=sum(st == OK for st in post) / max(len(post), 1),
            keyframes=sy.arena.n_keyframes(), points=sy.arena.n_points(),
            ate_cm=100 * ates[s], traj_lines=traj_lines[s],
            track_ms_median=statistics.median(r["track_ms"] for r in recs),
            mapping_ms_median=statistics.median(r["mapping_ms"] for r in recs),
            kf_mapping_ms_median=statistics.median(
                [r["mapping_ms"] for r in recs if r["mapping_ms"] > 1.0] or [0.0]),
            loops=sy.loop_closer.n_loops_closed))
    round_ms = statistics.median(ms.frame_ms[5:])
    print(f"multiseq: {S} sequences x {MULTISEQ_FRAMES} frames at "
          f"{cam.width}x{cam.height} ({cfg.orb.n_features} features, "
          f"{cfg.orb.n_levels} levels) in {wall_s:.1f} s; aggregate "
          f"{fps:.3f} fps (host clock over rounds 5-{MULTISEQ_FRAMES - 1}), "
          f"round median {round_ms:.1f} ms; {steady_rounds} rounds with a "
          f"steady sequence, {n_batch[0]} batched extractions, {builds.n} "
          f"classic frame builds; launches {launches}; {card}", flush=True)
    for s, q in enumerate(seqs):
        print(f"multiseq sequence {s}: initialized at frame {q['init_at']}, "
              f"{100 * q['tracked_after_init']:.1f}% tracked after it, ends "
              f"{q['final']}, {q['keyframes']} keyframes, {q['points']} "
              f"points, ATE (Sim3-aligned) {q['ate_cm']:.3f} cm, "
              f"{q['traj_lines']} trajectory lines, loops {q['loops']}; "
              f"track median {q['track_ms_median']:.3f} ms, mapping median "
              f"{q['mapping_ms_median']:.3f} ms over all frames, "
              f"{q['kf_mapping_ms_median']:.3f} ms over those that inserted "
              f"keyframes (host clock)", flush=True)
    for s, q in enumerate(seqs):
        if q["final"] != "OK":
            fail(f"multiseq sequence {s} ends {q['final']}, not OK")
        if q["keyframes"] < 3 or q["points"] <= 100:
            fail(f"multiseq sequence {s}: {q['keyframes']} keyframes, "
                 f"{q['points']} points (need >= 3, > 100)")
        if not q["ate_cm"] < 100 * MAX_MULTISEQ_ATE_M:
            fail(f"multiseq sequence {s}: ATE {q['ate_cm']:.3f} cm")
        if q["tracked_after_init"] < MIN_TRACKED_SHARE:
            fail(f"multiseq sequence {s} tracked "
                 f"{100 * q['tracked_after_init']:.1f}% after initialization")
        if q["traj_lines"] <= 10:
            fail(f"multiseq sequence {s}: {q['traj_lines']} trajectory lines")
    if any(n != (1 if st else 0) for st, n in rounds):
        fail(f"multiseq: batched extractions per round {rounds} (steady, "
             f"calls): not one per round with a steady sequence")
    check_build_launches("multiseq", launches, steady_rounds + builds.n)
    if "imgs" not in kept:
        fail("multiseq: no round had every sequence steady")

    # One round's images: the batch-S pack against S single-image packs, the
    # batched extraction's share of a round, kernels A and B at batch S.
    fb = ms.shared_builder
    imgs = kept["imgs"]
    packed = fb.extract_packed_batch(imgs)
    for s in range(S):
        one = fb.extract_packed(imgs[s])
        if not torch.equal(packed[s].view(torch.int32), one.view(torch.int32)):
            fail(f"multiseq: batch-{S} pack row {s} differs from the single "
                 f"pack in {int((packed[s].view(torch.int32) != one.view(torch.int32)).sum())} "
                 f"words")
    extract_ms = cuda_ms(torch, lambda: fb.extract_packed_batch(imgs), reps=10)
    extract_dev, extract_kernels = stage_device_ms(
        torch, lambda: fb.extract_packed_batch(imgs), reps=5)
    print(f"multiseq: the batch-{S} pack equals {S} single-image packs bit for "
          f"bit; the batched extraction {extract_ms:.3f} ms call (CUDA events), "
          f"{extract_dev:.3f} ms device in {extract_kernels} kernels, "
          f"{100 * extract_ms / round_ms:.2f}% of the round median "
          f"{round_ms:.1f} ms; kernels A and B each once per round with a "
          f"steady sequence ({steady_rounds}) plus once per classic build "
          f"({builds.n}); {card}", flush=True)
    img = fb._upload(imgs)
    _, canvas, xy, levels = fb.extractor.detect(img)
    for lvl, k_out in zip(levels, fast.fast_score_nms_levels(levels, 19)):
        if not torch.equal(k_out, fast.nms3x3(fast.fast_score_map(lvl, 19))):
            fail(f"kernel A differs from the plain version on the batch-{S} "
                 f"level {tuple(lvl.shape)}")
    run_a = lambda: fast.fast_score_nms_levels(levels, 19)
    px = sum(l.numel() for l in levels)
    a_shape = dict(
        shape=[tuple(l.shape) for l in levels], launches_per_frame=1,
        ms=cuda_ms(torch, run_a),
        device_ms=device_ms(torch, run_a, "fast_score_nms_kernel"),
        plain_ms=cuda_ms(torch, lambda: [fast.nms3x3(fast.fast_score_map(l, 19))
                                         for l in levels]),
        bound=bound_ms(8.0 * px, 330.0 * px), bytes_ms=bound_ms(8.0 * px, 0.0)[0],
        minmax_ms=1e3 * 106.0 * px / (F32_OPS_PER_S / 4), pixels=px)
    pb, _, _ = check_kernel_b(canvas, xy)
    n_read = canvas_floats_read(torch, patches, canvas, xy)
    run_s = lambda: patches.gather_blur_describe(canvas, xy, 21)
    dev_s, n_s = stage_device_ms(torch, run_s)
    b_shape = dict(
        shape=[tuple(canvas.shape), tuple(xy.shape)], launches_per_frame=1,
        ms=cuda_ms(torch, run_s), device_ms=dev_s, kernels=n_s,
        plain_ms=cuda_ms(torch, lambda: patches.gather_blur_describe_plain(
            canvas, xy, 21)),
        bound=describe_bound(n_read, xy, pb.shape[-1]),
        canvas_floats=canvas.numel(), canvas_floats_read=n_read)
    if n_s != 1:
        fail(f"the describe stage launched {n_s} kernels at batch {S}")
    for label, r in ((f"kernel A (8 levels of {S} images, B = {S})", a_shape),
                     (f"kernel B describe mode ({S} x {xy.shape[1]} slots)",
                      b_shape)):
        print(f"{label} at the multi-sequence shape {r['shape']}: device "
              f"{r['device_ms']:.5f} ms, call {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]})"
              + (f"; this design's: bytes {r['bytes_ms']:.5f} ms, min/max "
                 f"issue {r['minmax_ms']:.5f} ms ({px} pixels)"
                 if "bytes_ms" in r else
                 f"; {n_read} of the canvas's {canvas.numel()} floats inside "
                 f"the keypoints' windows") + f"; {card}", flush=True)
    full = dict(
        sequences=seqs, fps=fps, round_ms_median=round_ms, wall_s=wall_s,
        steady_rounds=steady_rounds, batched_extractions=n_batch[0],
        classic_builds=builds.n, launches=launches,
        launches_per_round=launches["fast_score_nms"] / len(rounds),
        extract_ms=extract_ms, extract_device_ms=extract_dev,
        extract_kernels=extract_kernels, extract_share=extract_ms / round_ms)

    # 12b: the batched front-end step over rendered frames, then its last
    # call's inputs on the CPU; then a tracked state (the previous
    # descriptors the frame's own, the points its keypoints back-projected
    # 4 m out from a camera 2 cm off) on both.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fr = multiseq_throughput.run_frontend(FRONTEND_SEQS, FRONTEND_FRAMES,
                                          device="cuda")
    torch.cuda.synchronize()
    fe_wall = time.perf_counter() - t0
    fe_launches = dict(kernels.LAUNCHES)
    check_build_launches("multiseq front end", fe_launches, FRONTEND_FRAMES + 1)
    H, W = multiseq_throughput.FRONTEND_H, multiseq_throughput.FRONTEND_W
    NF = multiseq_throughput.FRONTEND_FEATURES
    NL = multiseq_throughput.FRONTEND_LEVELS
    cpu_step, _ = multiseq.make_multiseq_step(H, W, NF, NL, FRONTEND_SEQS,
                                              device="cpu")
    step = fr["step"]

    def agree(label, inputs, exact):
        T, n_in, n_match = step(*inputs)
        cT, c_in, c_match = cpu_step(*[x.cpu() if torch.is_tensor(x) else x
                                      for x in inputs])
        T = T.cpu()
        err = float((T - cT).abs().max())
        R = T[:, :3, :3]
        orth = float((R @ R.transpose(1, 2) - torch.eye(3)).abs().max())
        got = (int(n_match), int(n_in))
        want = (int(c_match), int(c_in))
        print(f"multiseq front end, {label}: card (matched, inliers) {got}, "
              f"CPU {want}; max |T - T_cpu| {err:.3g}; rotations orthonormal "
              f"within {orth:.3g}", flush=True)
        close = (got == want if exact else
                 all(abs(g - w) <= 0.01 * w for g, w in zip(got, want)))
        if not close or not err <= 1e-3 or not orth <= 1e-3:
            fail(f"multiseq front end, {label}: the card's step disagrees "
                 f"with the CPU's ({got} against {want}, T {err:.3g}, "
                 f"orthonormal {orth:.3g})")
        return dict(card=got, cpu=want, max_T_err=err, orth_err=orth)

    checks = {"last_frame": agree("the last frame's inputs", fr["inputs"],
                                  True)}
    imgs_fe, _, prev_valid, _, Tcw0 = fr["inputs"]
    feats = ORBExtractor(ORBConfig(n_features=NF, n_levels=NL), H, W)(
        torch.from_numpy(imgs_fe))
    xy = feats.xy
    f = 0.8 * W
    pts = torch.cat([(xy - torch.tensor([W / 2, H / 2])) / f * 4.0,
                     torch.full(xy.shape[:2] + (1,), 4.0)], -1)
    pts = pts + torch.tensor([0.02, 0.0, 0.0])
    tracked = (imgs_fe, feats.desc, feats.valid, pts, Tcw0.cpu())
    checks["tracked"] = agree("a tracked state", tracked, False)
    if checks["tracked"]["cpu"][0] < 100 * FRONTEND_SEQS:
        fail(f"multiseq front end: the tracked state matched only "
             f"{checks['tracked']['cpu'][0]}")
    dev_args = [torch.as_tensor(x).cuda() for x in tracked]
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(*dev_args)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t1))
    step_ms = cuda_ms(torch, lambda: step(*dev_args), reps=3)
    step_dev, step_kernels = stage_device_ms(torch, lambda: step(*dev_args),
                                             reps=3)
    print(f"multiseq front end: {FRONTEND_SEQS} sequences at {W}x{H} ({NF} "
          f"features, {NL} levels), {fr['frames']} frames in {fe_wall:.1f} s; "
          f"aggregate {fr['fps']:.3f} fps ({fr['ms_per_frame']:.3f} ms a frame, "
          f"host clock); one step on the tracked state: {step_kernels} "
          f"kernels, {step_dev:.3f} ms device, call {step_ms:.3f} ms (CUDA "
          f"events), wall median {statistics.median(walls):.3f} ms, device "
          f"idle share {1.0 - step_dev / step_ms:.3f}; launches "
          f"{fe_launches}; {card}", flush=True)
    frontend = dict(fps=fr["fps"], ms_per_frame=fr["ms_per_frame"],
                    frames=fr["frames"], wall_s=fe_wall, launches=fe_launches,
                    checks=checks, step_kernels=step_kernels,
                    step_device_ms=step_dev, step_call_ms=step_ms,
                    step_wall_ms=statistics.median(walls))
    wall = time.perf_counter() - t_phase
    print(f"phase 12 in {wall:.1f} s", flush=True)
    return dict(full=full, frontend=frontend, kernel_a=a_shape,
                kernel_b=b_shape, wall_s=wall)


def long_run_phase(torch, kernels, card) -> tuple:
    """Phase 13a (see the module docstring); returns (its numbers, the
    System, the solver inputs it captured). Spies set in this function on local_ba.bundle_adjust /
    bundle_adjust_cg (each global-BA chunk: solver and keyframes),
    GBARunner._solve and take_result (each solve, each applied result),
    pose_graph.optimize_sim3 and optimize_essential_graph (the inputs of
    their last call); the package has no switch for any of them."""
    from orb_slam_system_tpu_torch.drivers import endurance_synthetic
    from orb_slam_system_tpu_torch.models import frame as frame_mod
    from orb_slam_system_tpu_torch.models import loop_closing
    from orb_slam_system_tpu_torch.solvers import local_ba, pose_graph
    gba = loop_closing.GBARunner
    cut = loop_closing.GBA_DENSE_MAX_CAMS
    chunks, solves, applied, captured = [], [], [], {}
    spied = [(local_ba, "bundle_adjust"), (local_ba, "bundle_adjust_cg"),
             (pose_graph, "optimize_sim3"),
             (pose_graph, "optimize_essential_graph"),
             (gba, "_solve"), (gba, "take_result")]
    originals = {name: getattr(mod, name) for mod, name in spied}

    def chunk_spy(name):
        def call(*a, **kw):
            # A global-BA chunk runs CHUNK_ITERS iterations (local BA 5 and
            # 10, the initializer's 20).
            if kw.get("n_iters") == gba.CHUNK_ITERS:
                C = int(a[0].Tcw.shape[0])
                chunks.append((name, C))
                if name == "bundle_adjust_cg" and C > cut:
                    captured.setdefault("pcg_chunk", (a, kw))
            return originals[name](*a, **kw)
        return call

    def last_call(name):
        def call(*a, **kw):
            captured[name] = (a, kw)
            return originals[name](*a, **kw)
        return call

    def solve(runner, snapshot, cam):
        n0, t0 = len(chunks), time.perf_counter()
        originals["_solve"](runner, snapshot, cam)
        solves.append(dict(C=int(snapshot[0].Tcw.shape[0]),
                           solvers=sorted({n for n, _ in chunks[n0:]}),
                           chunks=len(chunks) - n0, aborted=runner._abort,
                           wall_s=time.perf_counter() - t0))

    def take(runner):
        r = originals["take_result"](runner)
        if r is not None:
            applied.append(len(r[0]))
        return r

    spies = {"bundle_adjust": chunk_spy("bundle_adjust"),
             "bundle_adjust_cg": chunk_spy("bundle_adjust_cg"),
             "optimize_sim3": last_call("optimize_sim3"),
             "optimize_essential_graph": last_call("optimize_essential_graph"),
             "_solve": solve, "take_result": take}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for mod, name in spied:
        setattr(mod, name, spies[name])
    t0 = time.perf_counter()
    try:
        with BuildCount(frame_mod) as builds:
            slam, s = endurance_synthetic.run(
                LONG_FRAMES, None, verbose=True, n_features=LONG_FEATURES,
                leaves=LONG_LEAVES, device="cuda")
    finally:
        for mod, name in spied:
            setattr(mod, name, originals[name])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    recs = slam.telemetry.records
    peak_at = max(range(len(recs)), key=lambda i: recs[i]["n_kfs"])
    lc = slam.loop_closer
    pcg_applied = [C for C in applied if C > cut and any(
        v["C"] == C and v["solvers"] == ["bundle_adjust_cg"]
        and v["chunks"] == gba.N_CHUNKS for v in solves)]
    print(f"endurance clover: {LONG_FRAMES} frames, {LONG_LEAVES} leaves, "
          f"320x240, {LONG_FEATURES} features, in {wall_s:.1f} s ({builds.n} "
          f"frame builds); tracked {s['n_tracked']}/{LONG_FRAMES}; loops "
          f"closed {s['loops_closed']} (last {lc.last_loop}); ATE RMSE "
          f"(Sim3-aligned) {100 * s['ate_rmse_m']:.3f} cm; keyframes "
          f"{s['n_keyframes_final']} at the end, {recs[peak_at]['n_kfs']} at "
          f"the peak (frame {peak_at}, {recs[peak_at]['n_mps']} points); "
          f"points {s['n_points_final']} at the end; epoch violations "
          f"{slam.tracker.epoch_violations}; host ms median by thirds "
          f"{[round(x, 3) for x in s['host_ms_median_thirds']]}, p90 "
          f"{[round(x, 3) for x in s['host_ms_p90_thirds']]}; peak device "
          f"memory {peak_bytes} bytes (torch.cuda.max_memory_allocated); "
          f"loop_closer.stats {s['loop_stats']}; reloc_stats "
          f"{s['reloc_stats']}; kf_mp_median {s['kf_mp_median']}; launches "
          f"{launches}; {card}", flush=True)
    for v in solves:
        print(f"global BA solve: C = {v['C']} keyframes, {v['chunks']} chunks "
              f"through {v['solvers']}, aborted {v['aborted']}, "
              f"{v['wall_s']:.3f} s on its thread", flush=True)
    print(f"global BAs applied at C = {applied} (GBA_DENSE_MAX_CAMS {cut}); "
          f"through bundle_adjust_cg past it: {pcg_applied}", flush=True)
    print(f"local mapper stage ms, mean of the first 20 calls: "
          f"{ {k: round(v, 3) for k, v in s['stage_ms_first20_mean'].items()} }; "
          f"of the last 20: "
          f"{ {k: round(v, 3) for k, v in s['stage_ms_last20_mean'].items()} }; "
          f"{card}", flush=True)
    m1, _, m3 = s["host_ms_median_thirds"]
    if s["n_tracked"] < MIN_TRACKED_SHARE * LONG_FRAMES:
        fail(f"the clover tracked {s['n_tracked']} of {LONG_FRAMES} frames")
    if s["loops_closed"] < 1:
        fail("the clover closed no loop")
    if not pcg_applied:
        fail(f"no global BA through bundle_adjust_cg past {cut} keyframes "
             f"was applied (solves {solves}, applied {applied})")
    if s["n_keyframes_peak"] <= cut:
        fail(f"the clover's map peaked at {s['n_keyframes_peak']} keyframes "
             f"(<= {cut})")
    if not s["ate_rmse_m"] < MAX_LONG_ATE_M:
        fail(f"clover ATE {100 * s['ate_rmse_m']:.3f} cm >= "
             f"{100 * MAX_LONG_ATE_M:g} cm")
    if slam.tracker.epoch_violations:
        fail(f"{slam.tracker.epoch_violations} pose-epoch violations")
    if m3 > MAX_THIRDS_RATIO * max(m1, 1.0):
        fail(f"the last third's host-ms median {m3:.1f} is over "
             f"{MAX_THIRDS_RATIO}x the first third's {m1:.1f}")
    check_build_launches("the endurance clover", launches, builds.n)

    # The long map's solves again on their inputs: the PCG chunk against
    # the dense Schur solve on the same chunk (the cut-over reading), each
    # over three calls; then the essential graph and OptimizeSim3 of the
    # last call, warm from the run, timed over one call and profiled over
    # one more (a profiled call of theirs costs 10-35 s of host time for
    # its 30,000-115,000 records).
    timed = {}
    a, kw = captured["pcg_chunk"]
    shapes = [tuple(a[0].Tcw.shape), tuple(a[0].points.shape),
              tuple(a[0].e_cam.shape)]
    for key, solver, fn in (
            ("pcg_chunk", "bundle_adjust_cg",
             lambda: originals["bundle_adjust_cg"](*a, **kw)),
            ("dense_chunk", "bundle_adjust",
             lambda: originals["bundle_adjust"](*a, n_iters=kw["n_iters"]))):
        call_ms = cuda_ms(torch, fn, reps=3)
        d_ms, n_k = stage_device_ms(torch, fn, reps=3, required=False)
        timed[key] = dict(solver=solver, kernels=n_k, device_ms=d_ms,
                          call_ms=call_ms, shapes=shapes, calls=3)
        idle = "not measured" if d_ms is None else f"{1.0 - d_ms / call_ms:.3f}"
        print(f"long map {key} ({solver}) on the run's inputs {shapes}: "
              f"{n_k} device kernels, {ms_text(d_ms)} summed device time "
              f"(profiler), call {call_ms:.3f} ms (CUDA events, 3 calls), "
              f"device idle share {idle}; {card}", flush=True)
    for name in ("optimize_essential_graph", "optimize_sim3"):
        ca, ckw = captured[name]
        fn = (lambda f=originals[name], ca=ca, ckw=ckw: f(*ca, **ckw))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        captured[name + "_result"] = fn()     # phase 14d's reference
        end.record()
        torch.cuda.synchronize()
        call_ms = start.elapsed_time(end)
        prof = profile_device(torch, f"long map {name}, one profiled call",
                              fn, call_ms)
        n_k, d_ms = (None, None) if prof is None else prof[:2]
        timed[name] = dict(
            solver=name, kernels=n_k, device_ms=d_ms, call_ms=call_ms,
            calls=1, shapes=[tuple(x.shape) for x in ca
                             if torch.is_tensor(x) and x.dim() >= 2][:2])
        print(f"long map {name} on the run's inputs {timed[name]['shapes']}: "
              f"call {call_ms:.3f} ms (CUDA events, one call); {card}",
              flush=True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clover_map.npz")
        t0 = time.perf_counter()
        slam.save_map(path)
        save_ms = 1e3 * (time.perf_counter() - t0)
        map_bytes = os.path.getsize(path)
    n_kf = slam.arena.n_keyframes()
    print(f"long map saved: {map_bytes} bytes for {n_kf} keyframes and "
          f"{slam.arena.n_points()} points, {map_bytes / max(n_kf, 1):.1f} "
          f"bytes per keyframe, {save_ms:.1f} ms", flush=True)
    return dict(
        frames=LONG_FRAMES, leaves=LONG_LEAVES, builds=builds.n,
        n_tracked=s["n_tracked"], loops=s["loops_closed"],
        last_loop=lc.last_loop, ate_cm=100 * s["ate_rmse_m"],
        keyframes_final=s["n_keyframes_final"],
        keyframes_peak=recs[peak_at]["n_kfs"], peak_frame=peak_at,
        points_at_peak=recs[peak_at]["n_mps"], points_final=s["n_points_final"],
        epoch_violations=slam.tracker.epoch_violations,
        host_ms_median_thirds=s["host_ms_median_thirds"],
        host_ms_p90_thirds=s["host_ms_p90_thirds"],
        stage_ms_first20_mean=s["stage_ms_first20_mean"],
        stage_ms_last20_mean=s["stage_ms_last20_mean"],
        loop_stats=s["loop_stats"], gba_solves=solves, gba_applied_C=applied,
        peak_device_bytes=peak_bytes, map_bytes=map_bytes,
        map_bytes_per_keyframe=map_bytes / max(n_kf, 1), save_ms=save_ms,
        solves=timed, wall_s=wall_s, launches=launches), slam, captured


def viewer_phase(torch, kernels, slam, card) -> dict:
    """Phase 13b (see the module docstring) on 13a's System, then ARDemo on
    a fresh System; returns its numbers."""
    import urllib.request

    from orb_slam_system_tpu_torch.drivers import (endurance_synthetic,
                                                   mono_synthetic)
    from orb_slam_system_tpu_torch.models import ar, viewer
    from orb_slam_system_tpu_torch.models import frame as frame_mod
    from orb_slam_system_tpu_torch.models.system import System
    out: dict = {}
    cfg = slam.cfg
    last = endurance_synthetic.make_renderer(cfg).render(
        endurance_synthetic.clover_trajectory(
            LONG_FRAMES, leaves=LONG_LEAVES)[-1])
    tr = slam.tracker
    t0 = time.perf_counter()
    tracked, vo = viewer._point_classes(tr.current)
    ann = viewer.annotate_frame(last, viewer.frame_xy(tr.current), tracked,
                                vo_mask=vo, init_vis=tr.init_vis)
    line = viewer.status_text(slam.get_tracking_state(),
                              slam.arena.n_keyframes(), slam.arena.n_points(),
                              int((tracked & ~vo).sum()), n_vo=int(vo.sum()),
                              localization=tr.only_tracking)
    out["annotate_ms"] = 1e3 * (time.perf_counter() - t0)
    green = int(np.all(ann == viewer.GREEN, axis=2).sum())
    print(f"viewer: last frame annotated {ann.shape} {ann.dtype} in "
          f"{out['annotate_ms']:.2f} ms, {int(tracked.sum())} tracked "
          f"features, {green} green pixels; status: {line}", flush=True)
    if ann.shape != (cfg.camera.height, cfg.camera.width, 3) or not green:
        fail("the annotated last frame is malformed or has no tracked box")
    if slam.get_tracking_state().name not in line:
        fail(f"the status line lacks the state: {line}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.ply")
        t0 = time.perf_counter()
        viewer.export_map_ply(path, slam.arena)
        out["ply_ms"] = 1e3 * (time.perf_counter() - t0)
        out["ply_bytes"] = os.path.getsize(path)
        head = open(path).read(400)
    n_vert = slam.arena.n_points() + slam.arena.n_keyframes()
    print(f"export_map_ply of the long map: {out['ply_bytes']} bytes in "
          f"{out['ply_ms']:.1f} ms ({n_vert} vertices)", flush=True)
    if f"element vertex {n_vert}\n" not in head:
        fail("the PLY export's vertex count is not the map's")
    live = viewer.LiveViewer(slam, port=0)
    base = f"http://127.0.0.1:{live.port}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as resp:
                return resp.read()
        get("/frame.png")           # arms the frame gate
        t0 = time.perf_counter()
        live.update(last)
        out["live_update_ms"] = 1e3 * (time.perf_counter() - t0)
        m = json.loads(get("/map.json"))
        png = get("/frame.png")
    finally:
        live.shutdown()
    out["map_json_keyframes"] = len(m["kfs"])
    print(f"LiveViewer on port {live.port}: update {out['live_update_ms']:.2f} "
          f"ms; map.json {len(m['pts'])} points, {len(m['kfs'])} keyframes, "
          f"{len(m['edges'])} edges; frame.png {len(png)} bytes", flush=True)
    if len(m["kfs"]) != slam.arena.n_keyframes() or len(m["frusta"]) != len(m["kfs"]):
        fail(f"map.json has {len(m['kfs'])} keyframes, the map "
             f"{slam.arena.n_keyframes()}")
    if png[:8] != b"\x89PNG\r\n\x1a\n" or len(png) < 1000:
        fail("the live viewer served no annotated frame")

    # ARDemo over the first AR_FRAMES frames of phase 5's cached orbit.
    acfg = mono_synthetic.make_config(640, 480, 1000)
    frames, _ = mono_synthetic.render_sequence(acfg, SYSTEM_FRAMES)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    demo = ar.ARDemo(System(acfg, device="cuda"))
    plane_at, drawn, t0 = None, [], time.perf_counter()
    with BuildCount(frame_mod) as builds:
        for i, img in enumerate(frames[:AR_FRAMES]):
            shown = demo.process(img, i / 30.0)
            if demo.plane is not None and plane_at is None:
                plane_at = i
            changed = int((shown != np.clip(img, 0, 255).astype(np.uint8)).sum())
            if demo.plane is not None:
                drawn.append(changed)
    demo.system.shutdown()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    out.update(ar_frames=AR_FRAMES, ar_plane_at=plane_at, ar_cube_pixels=drawn,
               ar_wall_s=time.perf_counter() - t0, ar_builds=builds.n,
               ar_launches=launches,
               ar_points=demo.system.arena.n_points())
    print(f"ARDemo: {AR_FRAMES} frames 640x480 in {out['ar_wall_s']:.1f} s; "
          f"plane fitted at frame {plane_at} ({out['ar_points']} map points "
          f"at the end); cube pixels per frame after it {drawn}; launches "
          f"{launches}; {card}", flush=True)
    if plane_at is None:
        fail("ARDemo fitted no plane")
    if not any(n > 50 for n in drawn):
        fail("ARDemo drew no cube on a tracked frame")
    check_build_launches("the AR demo", launches, builds.n)
    return out


class ExtractCount:
    """Counts ORBExtractor.extract calls while active: each extraction,
    at any batch, launches kernel A and B's describe mode once (the
    front-end step extracts without a frame build)."""

    def __init__(self, extractor_mod):
        self.n = 0
        self._cls = extractor_mod.ORBExtractor
        self._orig = None

    def __enter__(self):
        orig = self._orig = self._cls.extract

        def counted(ex, *a, **kw):
            self.n += 1
            return orig(ex, *a, **kw)
        self._cls.extract = counted
        return self

    def __exit__(self, *exc):
        self._cls.extract = self._orig


def rgbd_config():
    """Phase 9's RGB-D camera: 640x480, bf 40, DepthMapFactor 5000."""
    from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig,
                                                  Sensor, SlamConfig)
    from orb_slam_system_tpu_torch.drivers import rgbd_synthetic
    W, H = 640, 480
    cam = CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, fps=30.0,
                       width=W, height=H, bf=40.0)
    # TUM's ThDepth 40 in baseline units, given in metres so that the JAX
    # package (which stores the number raw) sees the same threshold.
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=1000),
                      sensor=Sensor.RGBD, th_depth=40.0 * 40.0 / 520.0,
                      depth_map_factor=rgbd_synthetic.DEPTH_MAP_FACTOR)


def count_rows(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def run_node(torch, kernels, label: str, mod, argv, script, work: str):
    """Phase 14a: drivers/<node>.main over a ReplayRospy of `script` in a
    folder of its own, the counters set to 0 before it and read after it,
    and A and B's describe mode checked once per frame build. The node's
    System is recorded by a subclass set in its module for the call.
    Returns (the System, its numbers, its folder)."""
    from orb_slam_system_tpu_torch.dataio.ros_replay import ImageMsg, ReplayRospy
    from orb_slam_system_tpu_torch.models import frame as frame_mod
    wd = os.path.join(work, label)
    os.makedirs(wd)
    made, cls = [], mod.System

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    rospy = ReplayRospy(script)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    mod.System = Recorded
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        os.chdir(wd)
        with BuildCount(frame_mod) as builds:
            rc = mod.main(argv, rospy_module=rospy, image_cls=ImageMsg)
    finally:
        os.chdir(cwd)
        mod.System = cls
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if rc != 0:
        fail(f"{label} exited {rc}")
    check_build_launches(label, launches, builds.n)
    slam = made[0]
    recs = slam.telemetry.records
    return slam, dict(node=rospy.node_name, messages=len(script),
                      frames=len(recs), builds=builds.n, launches=launches,
                      wall_s=wall_s, async_mapping=slam.async_mapping,
                      track_ms_median=statistics.median(
                          r["track_ms"] for r in recs) if recs else None), wd


def bridge_phase(torch, kernels, card, phase5_track_ms) -> dict:
    """Phase 14 a-c (see the module docstring); returns its numbers.
    phase5_track_ms: phase 5's track ms per frame, in order."""
    import shutil

    from orb_slam_system_tpu_torch.config import (Sensor, TrackingState,
                                                  load_settings,
                                                  save_settings_yaml)
    from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
    from orb_slam_system_tpu_torch.dataio.ros_replay import ImageMsg
    from orb_slam_system_tpu_torch.dataio.synthetic import (
        PlanarSceneRenderer, make_texture, orbit_trajectory)
    from orb_slam_system_tpu_torch.drivers import (live_camera, mono_synthetic,
                                                   ros_mono, ros_mono_ar,
                                                   ros_rgbd, ros_stereo,
                                                   stereo_synthetic,
                                                   video_slam)
    from orb_slam_system_tpu_torch.models import frame as frame_mod
    from orb_slam_system_tpu_torch.models.system import System
    from orb_slam_system_tpu_torch.models.viewer import encode_png
    from orb_slam_system_tpu_torch.utils import warmup

    OK = TrackingState.OK
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = mono_synthetic.make_config(640, 480, 1000)
    frames, poses = mono_synthetic.render_sequence(cfg, SYSTEM_FRAMES)
    u8 = [np.clip(f, 0, 255).astype(np.uint8) for f in frames]
    out: dict = {}
    with tempfile.TemporaryDirectory() as work:
        settings = os.path.join(work, "tum_synthetic.yaml")
        save_settings_yaml(cfg, settings)

        # 14a. ros_mono over 30 of phase 5's renders.
        n = ROS_MONO_FRAMES
        slam, r, wd = run_node(
            torch, kernels, "ros_mono", ros_mono, ["none", settings],
            [("/camera/image_raw", ImageMsg.mono8(f, i / 30.0))
             for i, f in enumerate(frames[:n])], work)
        recs = slam.telemetry.records
        states = [x["state"] for x in recs]
        init_at = states.index(int(OK)) if int(OK) in states else None
        post = states[init_at + 1:] if init_at is not None else []
        gt = {i / 30.0: (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)
              for i, T in enumerate(poses[:n])}
        ate = traj_io.ate_rmse(
            traj_io.frame_poses(slam.arena, slam.tracker.trajectory), gt)
        r.update(init_frame=init_at, tracked_share=(
            sum(s == int(OK) for s in post) / max(len(post), 1)),
            keyframes=slam.arena.n_keyframes(), ate_cm=100 * ate,
            kf_rows=count_rows(os.path.join(wd, "KeyFrameTrajectory.txt")),
            state=slam.get_tracking_state().name)
        out["ros_mono"] = r
        print(f"ros_mono (node {r['node']}, async mapper {r['async_mapping']})"
              f": {n} mono8 messages of phase 5's 640x480 orbit, initialized "
              f"at frame {init_at}, {100 * r['tracked_share']:.1f}% tracked "
              f"after it, {r['keyframes']} keyframes, {r['kf_rows']} "
              f"KeyFrameTrajectory.txt rows, ATE (Sim3) {r['ate_cm']:.3f} cm, "
              f"state {r['state']}; track ms median "
              f"{r['track_ms_median']:.3f}, {r['wall_s']:.1f} s; launches "
              f"{r['launches']}; {card}", flush=True)
        if slam.get_tracking_state() != OK:
            fail(f"ros_mono ends {r['state']}, not OK")
        if r["tracked_share"] < MIN_TRACKED_SHARE:
            fail(f"ros_mono tracked {100 * r['tracked_share']:.1f}% after "
                 f"initialization")
        if r["kf_rows"] < 3:
            fail(f"ros_mono wrote {r['kf_rows']} keyframe rows")
        if not ate < MAX_ATE_M:
            fail(f"ros_mono ATE {r['ate_cm']:.3f} cm >= {100 * MAX_ATE_M:g} cm")

        # ros_stereo over phase 8's first pairs, the right stamps jittered.
        kitti = os.path.join(root, "orb_slam_system_tpu_torch", "settings",
                             "kitti00-02.yaml")
        scfg = load_settings(kitti, Sensor.STEREO)
        pairs, _ = stereo_synthetic.render_pairs(scfg, STEREO_FRAMES,
                                                 TEX_SCALE)
        rng = np.random.default_rng(0)
        script = []
        for i, (left, right) in enumerate(pairs[:ROS_FRAMES]):
            t = i / 10.0
            script.append(("/camera/left/image_raw", ImageMsg.mono8(left, t)))
            script.append(("/camera/right/image_raw", ImageMsg.mono8(
                right, t + rng.uniform(-0.004, 0.004))))
        slam, r, wd = run_node(torch, kernels, "ros_stereo", ros_stereo,
                               ["none", kitti, "false"], script, work)
        r.update(paired=len(slam.tracker.trajectory),
                 state=slam.get_tracking_state().name,
                 rows=count_rows(os.path.join(wd, "CameraTrajectory.txt")),
                 keyframes=slam.arena.n_keyframes(),
                 points=slam.arena.n_points())
        out["ros_stereo"] = r
        print(f"ros_stereo (node {r['node']}): {ROS_FRAMES} KITTI-width pairs "
              f"(1241x376), right stamps within 4 ms, {r['paired']} paired, "
              f"state {r['state']}, {r['keyframes']} keyframes, {r['points']} "
              f"points, {r['rows']} CameraTrajectory.txt rows; track ms "
              f"median {r['track_ms_median']:.3f}, {r['wall_s']:.1f} s; "
              f"launches {r['launches']}; {card}", flush=True)
        if r["paired"] != ROS_FRAMES or r["rows"] != ROS_FRAMES:
            fail(f"ros_stereo paired {r['paired']} and wrote {r['rows']} rows "
                 f"for {ROS_FRAMES} pairs")
        if slam.get_tracking_state() != OK:
            fail(f"ros_stereo ends {r['state']}, not OK")

        # ros_rgbd over phase 9's first frames, depth as 32FC1.
        rcfg = rgbd_config()
        rset = os.path.join(work, "rgbd.yaml")
        save_settings_yaml(rcfg, rset)
        cam = rcfg.camera
        rr = PlanarSceneRenderer(cam.K, cam.width, cam.height,
                                 texture=make_texture(size=2048, block=8,
                                                      seed=7),
                                 tex_scale=TEX_SCALE)
        rposes = orbit_trajectory(RGBD_FRAMES + LOCALIZE_FRAMES, radius=0.35,
                                  depth=-2.0, tilt=0.3)
        script = []
        for i, T in enumerate(rposes[:ROS_FRAMES]):
            depth = (rr.render_depth(T) * rcfg.depth_map_factor).astype(
                np.float32)
            script.append(("/camera/rgb/image_raw",
                           ImageMsg.mono8(rr.render(T), i / 30.0)))
            script.append(("/camera/depth_registered/image_raw",
                           ImageMsg.from_array(depth, i / 30.0, "32FC1")))
        slam, r, wd = run_node(torch, kernels, "ros_rgbd", ros_rgbd,
                               ["none", rset], script, work)
        r.update(state=slam.get_tracking_state().name,
                 frames_ok=sum(x["state"] == int(OK)
                               for x in slam.telemetry.records),
                 rows={name: count_rows(os.path.join(wd, name))
                       for name in ("KeyFrameTrajectory.txt",
                                    "CameraTrajectory.txt")})
        out["ros_rgbd"] = r
        print(f"ros_rgbd (node {r['node']}): {ROS_FRAMES} frames with 32FC1 "
              f"depth, {r['frames_ok']} OK, state {r['state']}, trajectory "
              f"rows {r['rows']}; track ms median "
              f"{r['track_ms_median']:.3f}, {r['wall_s']:.1f} s; launches "
              f"{r['launches']}; {card}", flush=True)
        if slam.get_tracking_state() != OK:
            fail(f"ros_rgbd ends {r['state']}, not OK")
        if not all(r["rows"].values()):
            fail(f"ros_rgbd trajectory files {r['rows']}")

        # ros_mono_ar over 10 of phase 5's renders.
        ar_dir = os.path.join(work, "ar_out")
        slam, r, _ = run_node(
            torch, kernels, "ros_ar", ros_mono_ar,
            ["none", settings, f"--out_dir={ar_dir}"],
            [("/camera/image_raw", ImageMsg.mono8(f, i / 30.0))
             for i, f in enumerate(frames[:ROS_FRAMES])], work)
        r["overlays"] = len(os.listdir(ar_dir)) if os.path.isdir(ar_dir) else 0
        out["ros_ar"] = r
        print(f"ros_mono_ar (node {r['node']}): {ROS_FRAMES} messages, "
              f"{r['overlays']} overlays written; {r['wall_s']:.1f} s; "
              f"launches {r['launches']}; {card}", flush=True)
        if r["overlays"] != ROS_FRAMES:
            fail(f"ros_mono_ar wrote {r['overlays']} overlays for "
                 f"{ROS_FRAMES} messages")

        # 14b. live_camera.run on a capture serving BGR renders.
        class Capture:
            def __init__(self):
                self.i, self.released = 0, False

            def read(self):
                if self.i >= len(u8):
                    return False, None
                g = u8[self.i]
                self.i += 1
                return True, np.stack([g, g, g], axis=-1)

            def release(self):
                self.released = True
        cap = Capture()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with BuildCount(frame_mod) as builds:
            slam = System(cfg, device="cuda", async_mapping=True)
            n_live = live_camera.run(slam, cap, max_frames=LIVE_FRAMES,
                                     report_every=0)
            state = slam.get_tracking_state()
            slam.shutdown()
        cap.release()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        check_build_launches("live_camera", launches, builds.n)
        recs = slam.telemetry.records
        out["live"] = dict(frames=n_live, read=cap.i, state=state.name,
                           keyframes=slam.arena.n_keyframes(),
                           wall_s=time.perf_counter() - t0,
                           chain_stats=dict(slam.tracker.chain_stats),
                           track_ms_median=statistics.median(
                               x["track_ms"] for x in recs),
                           builds=builds.n, launches=launches)
        print(f"live_camera.run (pipelined, async mapper): {n_live} BGR "
              f"frames read {cap.i}, state {state.name}, "
              f"{out['live']['keyframes']} keyframes, chain "
              f"{out['live']['chain_stats']}, {out['live']['wall_s']:.1f} s, "
              f"released {cap.released}; launches {launches}; {card}",
              flush=True)
        if n_live != LIVE_FRAMES or state != OK:
            fail(f"live_camera tracked {n_live} of {LIVE_FRAMES}, ends "
                 f"{state.name}")

        # video_slam.main on a folder of PNGs and one .txt file.
        src = os.path.join(work, "video")
        os.makedirs(src)
        for i, f in enumerate(u8[:VIDEO_FRAMES]):
            with open(os.path.join(src, f"{i:04d}.png"), "wb") as fh:
                fh.write(encode_png(f))
        with open(os.path.join(src, "notes.txt"), "w") as fh:
            fh.write("not a frame\n")
        made, cls = [], video_slam.System

        class Recorded(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)
        vout = os.path.join(work, "video_out")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        video_slam.System = Recorded
        t0 = time.perf_counter()
        try:
            with BuildCount(frame_mod) as builds:
                rc = video_slam.main(["none", settings, src, "--out-dir", vout])
        finally:
            video_slam.System = cls
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        check_build_launches("video_slam", launches, builds.n)
        slam = made[0]
        rows = count_rows(os.path.join(vout, "KeyFrameTrajectory.txt"))
        ffmpeg = shutil.which("ffmpeg")
        out["video"] = dict(
            frames=len(slam.telemetry.records), rows=rows,
            state=slam.get_tracking_state().name,
            wall_s=time.perf_counter() - t0, builds=builds.n,
            launches=launches, ffmpeg=ffmpeg,
            track_ms_median=statistics.median(
                x["track_ms"] for x in slam.telemetry.records))
        if rc != 0 or out["video"]["frames"] != VIDEO_FRAMES or rows < 1:
            fail(f"video_slam: rc {rc}, {out['video']['frames']} frames, "
                 f"{rows} trajectory rows")
        if ffmpeg:
            clip = os.path.join(work, "clip.mkv")
            subprocess.run([ffmpeg, "-loglevel", "error", "-framerate", "30",
                            "-i", os.path.join(src, "%04d.png"), "-c:v",
                            "ffv1", "-pix_fmt", "gray", clip], check=True)
            got = list(video_slam.iter_video(clip, 30.0, 640, 480))
            out["video"]["iter_video_frames"] = len(got)
            if len(got) != VIDEO_FRAMES or not np.array_equal(
                    got[0][0], u8[0].astype(np.float32)):
                fail(f"iter_video read {len(got)} frames of {VIDEO_FRAMES}, "
                     f"frame 0 not the PNG's")
        print(f"video_slam.main: {out['video']['frames']} PNG frames read "
              f"(notes.txt skipped), state {out['video']['state']}, {rows} "
              f"KeyFrameTrajectory.txt rows, {out['video']['wall_s']:.1f} s; "
              f"ffmpeg on PATH: {ffmpeg or 'no'}, iter_video "
              f"{'ran' if ffmpeg else 'not run'}; launches {launches}; {card}",
              flush=True)

    # 14c. System(prewarm=True) on phase 5's config, then its first frames.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with BuildCount(frame_mod) as builds:
        warmup.PREWARM_FRAMES = WARM_FRAMES
        slam = System(cfg, device="cuda", prewarm=True)
        t_warm = time.perf_counter() - t0
        for i in range(WARM_AFTER):
            slam.track_monocular(frames[i], i / 30.0)
        slam.shutdown()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_build_launches("the warm pass", launches, builds.n)
    after = [round(x["track_ms"], 3) for x in slam.telemetry.records]
    before = [round(x, 3) for x in phase5_track_ms[:WARM_AFTER]]
    out["warm"] = dict(frames_per_mode=WARM_FRAMES, seconds=slam.warm_seconds,
                       construct_s=t_warm, track_ms_after=after,
                       phase5_track_ms=before, builds=builds.n,
                       launches=launches)
    print(f"warm pass: System(prewarm=True) at 640x480, {WARM_FRAMES} frames "
          f"a mode: {slam.warm_seconds} s ({t_warm:.1f} s to construct); "
          f"track ms of the first {WARM_AFTER} frames after it {after}, "
          f"phase 5's first {WARM_AFTER} {before}; launches {launches}; "
          f"{card}", flush=True)
    if set(slam.warm_seconds) != {"sequential+sync", "pipelined+async"}:
        fail(f"the warm pass ran {slam.warm_seconds}")
    return out


def sharded_phase(torch, kernels, card, captured, solves13) -> dict:
    """Phase 14d (see the module docstring): an in-process NCCL group of
    one rank on card 0, the sharded global BA and essential graph on 13a's
    inputs against their unsharded solves, then multiseq.dryrun on it (and
    across the cards through dryrun_multichip where there are several).
    captured: 13a's captured inputs; solves13: 13a's timed solves."""
    import torch.distributed as dist

    from orb_slam_system_tpu_torch.ops import extractor as extractor_mod
    from orb_slam_system_tpu_torch.parallel import multiseq
    from orb_slam_system_tpu_torch.parallel.ba_dist import (
        bundle_adjust_cg_sharded)
    from orb_slam_system_tpu_torch.parallel.pose_graph_dist import (
        optimize_essential_graph_sharded)
    from orb_slam_system_tpu_torch.solvers import local_ba

    n_cards = torch.cuda.device_count()
    out: dict = {"cards": n_cards, "ranks": 1}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            # The unsharded solves' call ms and kernels are 13a's, on the
            # same inputs; the global BA runs once more for the bit
            # comparison, the essential graph's 13a result stands in.
            a, kw = captured["pcg_chunk"]
            shapes = [tuple(a[0].Tcw.shape), tuple(a[0].points.shape),
                      tuple(a[0].e_cam.shape)]

            def shard():
                return bundle_adjust_cg_sharded(*a, **kw)
            out["ba_bit_equal"] = all(torch.equal(x, y) for x, y in zip(
                local_ba.bundle_adjust_cg(*a, **kw), shard()))
            d_ms, n_k = stage_device_ms(torch, shard, reps=3, required=False)
            out["ba_sharded"] = dict(call_ms=cuda_ms(torch, shard, reps=3),
                                     kernels=n_k, device_ms=d_ms,
                                     shapes=shapes)
            plain = solves13["pcg_chunk"]
            print(f"sharded global BA on 13a's PCG chunk {shapes}, NCCL, 1 "
                  f"rank: call {out['ba_sharded']['call_ms']:.3f} ms, "
                  f"{n_k} kernels, {ms_text(d_ms)} device; unsharded (13a) "
                  f"call {plain['call_ms']:.3f} ms, {plain['kernels']} "
                  f"kernels, {ms_text(plain['device_ms'])} device; bit-equal "
                  f"{out['ba_bit_equal']}; {card}", flush=True)
            if not out["ba_bit_equal"]:
                fail("the sharded global BA at one rank differs from "
                     "bundle_adjust_cg")

            ca, ckw = captured["optimize_essential_graph"]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            got = optimize_essential_graph_sharded(*ca, **ckw)
            end.record()
            torch.cuda.synchronize()
            out["eg_sharded"] = dict(call_ms=start.elapsed_time(end),
                                     K=int(ca[0].shape[0]),
                                     E=int(ca[5].shape[0]))
            prof = profile_device(
                torch, "sharded essential graph, one profiled call",
                lambda: optimize_essential_graph_sharded(*ca, **ckw),
                out["eg_sharded"]["call_ms"])
            out["eg_sharded"]["kernels"], out["eg_sharded"]["device_ms"] = (
                (None, None) if prof is None else prof[:2])
            plain = solves13["optimize_essential_graph"]
            out["eg_bit_equal"] = all(torch.equal(x, y) for x, y in zip(
                captured["optimize_essential_graph_result"], got))
            print(f"sharded essential graph on 13a's last inputs "
                  f"(K = {out['eg_sharded']['K']}, E = {out['eg_sharded']['E']}"
                  f"), NCCL, 1 rank: call {out['eg_sharded']['call_ms']:.1f} "
                  f"ms, {out['eg_sharded']['kernels']} kernels; unsharded "
                  f"(13a) call {plain['call_ms']:.1f} ms, {plain['kernels']} "
                  f"kernels; bit-equal {out['eg_bit_equal']}; {card}",
                  flush=True)
            if not out["eg_bit_equal"]:
                fail("the sharded essential graph at one rank differs from "
                     "optimize_essential_graph")

            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with ExtractCount(extractor_mod) as ex:
                n_in, n_match = multiseq.dryrun(1)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            out["dryrun"] = dict(n_inliers=n_in, n_matched=n_match,
                                 extractions=ex.n, launches=launches,
                                 wall_s=time.perf_counter() - t0)
        finally:
            dist.destroy_process_group()
    print(f"multiseq.dryrun(1) on the NCCL group: the dp x sp step, the "
          f"sharded essential graph and global BA, and the 2-System "
          f"MultiSystem OK; n_inliers {n_in}, n_matched {n_match}; "
          f"{ex.n} extractions, launches {launches}, "
          f"{out['dryrun']['wall_s']:.1f} s; {card}", flush=True)
    for name, want in (("fast_score_nms", ex.n), ("gather_blur_describe", ex.n),
                       ("brief_pack", 0), ("gather_blur_moments", 0),
                       ("gather_patches", 0)):
        if launches[name] != want:
            fail(f"dryrun: kernel {name} launched {launches[name]} times for "
                 f"{ex.n} extractions")
    if n_cards > 1:
        t0 = time.perf_counter()
        multiseq.dryrun_multichip(n_cards, "nccl")
        out["dryrun_multichip_s"] = time.perf_counter() - t0
        out["ranks"] = n_cards
        print(f"dryrun_multichip({n_cards}, nccl) OK in "
              f"{out['dryrun_multichip_s']:.1f} s", flush=True)
    return out


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
        from orb_slam_system_tpu_torch.dataio import trajectory as traj_io
        from orb_slam_system_tpu_torch.drivers import loop_synthetic, mono_synthetic
        from orb_slam_system_tpu_torch.models import loop_closing
        from orb_slam_system_tpu_torch.dataio.synthetic import (
            PlanarSceneRenderer, make_texture, orbit_trajectory)
        from orb_slam_system_tpu_torch.models.frame import FrameBuilder
        from orb_slam_system_tpu_torch.models.track_device import (
            TrackPrograms, unpack)
        from orb_slam_system_tpu_torch.models.tracking import (
            LOCAL_MAP_SLOTS, fused_track_step, seed_map_from_depth)
        from orb_slam_system_tpu_torch.ops import brief, fast, patches
        from orb_slam_system_tpu_torch.ops.brief import _angle_bins
        from orb_slam_system_tpu_torch.ops.orientation import angles_from_moments
        from orb_slam_system_tpu_torch.ops.pyramid import build_pyramid
        from orb_slam_system_tpu_torch.solvers import local_ba, pnp, pose_graph, sim3
        from orb_slam_system_tpu_torch.utils import kernels
        from orb_slam_system_tpu_torch.utils.metrics import take_spans
        from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary
    except ImportError as e:
        fail(f"the port does not import (run from the repository root): {e}")
    if "jax" in sys.modules:
        fail("the port imported jax")
    from orb_slam_system_tpu_torch.dataio import synthetic
    renders = memoize_renders(synthetic)
    t_script = time.perf_counter()

    def phases_done(last: int) -> None:
        print(f"phases 1-{last} done at {time.perf_counter() - t_script:.1f} s "
              f"(renders cached: {len(renders)})", flush=True)

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
    for lvl, k_out in zip(levels, fast.fast_score_nms_levels(levels, 19)):
        p_out = fast.nms3x3(fast.fast_score_map(lvl, 19))
        if not torch.equal(k_out, p_out):
            n_bad = int((k_out != p_out).sum())
            fail(f"kernel A differs from the plain version on level "
                 f"{tuple(lvl.shape)}: {n_bad} pixels")
        errs_a.append(float((k_out - p_out).abs().max()))
    run_a = lambda: fast.fast_score_nms_levels(levels, 19)
    ms_a = cuda_ms(torch, run_a)
    dev_a = device_ms(torch, run_a, "fast_score_nms_kernel")
    plain_a = cuda_ms(torch, lambda: [fast.nms3x3(fast.fast_score_map(l, 19))
                                      for l in levels])
    # Bound: each level read and written once, and per pixel the first
    # design's ~330 operations (16 arcs x 16 min/max, 32 reductions, 9 NMS
    # max) at the f32 peak, kept unchanged so the row compares across
    # versions of the kernel.
    # The current design (csrc/fast_score_nms.cu) does 16 differences, 97
    # min/max for the segment test and 9 max for the NMS per pixel: at the
    # f32 peak that takes less than its bytes, so its own bound is the
    # bytes'. min/max issue at a quarter of that peak (CUDA C++ Programming
    # Guide, sm_90: 64 results per clock per SM against 128 FMAs of two
    # operations); at that rate its 106 min/max per pixel take minmax_a.
    px = sum(l.numel() for l in levels)
    bytes_a = bound_ms(8.0 * px, 0.0)[0]
    minmax_a = 1e3 * 106.0 * px / (F32_OPS_PER_S / 4)
    report["fast_score_nms"] = dict(
        source="orb_slam_system_tpu_torch/csrc/fast_score_nms.cu",
        replaces="orb_slam_system_tpu/ops/fast_pallas.py:108",
        max_abs_err=max(errs_a), ms=ms_a, device_ms=dev_a, plain_ms=plain_a,
        bound=bound_ms(8.0 * px, 330.0 * px), library_ms=None)
    print(f"kernel A fast_score_nms: bit-exact on {len(levels)} levels "
          f"{[tuple(l.shape[1:]) for l in levels]} in one launch; call "
          f"{ms_a:.4f} ms, device {dev_a:.4f} ms (plain {plain_a:.4f} ms) per "
          f"frame; bound {report['fast_score_nms']['bound'][0]:.4f} ms at the "
          f"first design's operation count, this design's: bytes "
          f"{bytes_a:.4f} ms, min/max issue {minmax_a:.4f} ms; {card}",
          flush=True)


    ex_init = FrameBuilder(cfg, dev, n_features=2 * cfg.orb.n_features).extractor
    check_kernel_b(*ex_init.detect(img)[1:3])
    _, canvas, xy_all, _ = ex.detect(img)
    pb, pm, mom_err = check_kernel_b(canvas, xy_all)
    n_kp = xy_all.shape[1]
    pb_side = pb.shape[-1]
    Bc, Hc, Wc = canvas.shape
    flat = patches.gather_flat_index(xy_all, 21, Hc, Wc)
    n_read = canvas_floats_read(torch, patches, canvas, xy_all)
    # Operations per keypoint: the two blur passes over the 37x43 and
    # 37x37 outputs (blur mode), the moments over the 749-pixel circle,
    # and per rBRIEF test two bf16 roundings and a compare.
    ops_pass1 = 2 * 7 * pb_side * 43
    ops_blur = n_kp * (ops_pass1 + 2 * 7 * pb_side ** 2 + 4 * 749)
    ops_c = 3.0 * 256 * n_kp
    run_b = lambda: patches.gather_blur_moments(canvas, xy_all, 21)
    ms_b = cuda_ms(torch, run_b)
    dev_b = device_ms(torch, run_b, "gather_blur_moments_kernel")
    plain_b = cuda_ms(torch, lambda: patches.gather_blur_moments_plain(
        canvas, xy_all, 21))
    # Blur mode: the windows' canvas and the centres read once, blurred
    # patches and moments written once.
    bound_b = bound_ms(4.0 * (n_read + xy_all.numel() + pb.numel()
                              + pm.numel()), ops_blur)
    run_s = lambda: patches.gather_blur_describe(canvas, xy_all, 21)
    ms_s = cuda_ms(torch, run_s)
    dev_s, n_s = stage_device_ms(torch, run_s)
    plain_s = cuda_ms(torch, lambda: patches.gather_blur_describe_plain(
        canvas, xy_all, 21))

    def run_chain():
        blurred, mom = patches.gather_blur_moments(canvas, xy_all, 21)
        return brief.brief_pack(blurred, angles_from_moments(mom))
    ms_chain = cuda_ms(torch, run_chain)
    dev_chain, n_chain = stage_device_ms(torch, run_chain)
    bound_s = describe_bound(n_read, xy_all, pb_side)
    # The chain moves the blurred patch out and back in, and the angle
    # through device memory.
    bound_chain = bound_ms(4.0 * (n_read + xy_all.numel()
                                  + 2 * pb.numel() + 14 * n_kp),
                           ops_blur + ops_c)
    report["gather_blur_moments"] = dict(
        source="orb_slam_system_tpu_torch/csrc/gather_blur_moments.cu",
        replaces="orb_slam_system_tpu/ops/gather_pallas.py:336",
        mode="describe", max_abs_err=mom_err, ms=ms_s, device_ms=dev_s,
        plain_ms=plain_s, bound=bound_s, library_ms=None,
        canvas_floats=canvas.numel(), canvas_floats_read=n_read,
        blur_mode=dict(ms=ms_b, device_ms=dev_b, plain_ms=plain_b,
                       bound_ms=bound_b[0]),
        replaced_chain=dict(ms=ms_chain, device_ms=dev_chain,
                            kernels=n_chain, bound_ms=bound_chain[0]))
    print(f"kernel B describe mode (the System's route) at {n_kp} slots, "
          f"{n_read} of the canvas's {canvas.numel()} floats inside the "
          f"keypoints' windows: "
          f"{n_s} kernel(s), device {dev_s:.5f} ms, call {ms_s:.4f} ms (plain "
          f"{plain_s:.4f} ms), bound {bound_s[0]:.5f} ms ({bound_s[1]}); the "
          f"chain it replaces (blur mode -> angles_from_moments -> kernel C): "
          f"{n_chain} kernels, device {dev_chain:.5f} ms, call "
          f"{ms_chain:.4f} ms, bound {bound_chain[0]:.5f} ms "
          f"({bound_chain[1]}); blur mode: device {dev_b:.5f} ms, call "
          f"{ms_b:.4f} ms (plain {plain_b:.4f} ms), bound {bound_b[0]:.5f} "
          f"ms ({bound_b[1]}); {card}", flush=True)
    if n_s != 1:
        fail(f"the describe stage launched {n_s} kernels, not 1")

    ang = angles_from_moments(pm)
    kc = brief.brief_pack(pb, ang)
    pc = brief.brief_pack_plain(pb, ang)
    if not torch.equal(kc, pc):
        fail(f"kernel C differs in {int((kc != pc).any(-1).sum())} keypoints")
    run_c = lambda: brief.brief_pack(pb, ang)
    ms_c = cuda_ms(torch, run_c)
    dev_c = device_ms(torch, run_c, "brief_pack_kernel")
    plain_c = cuda_ms(torch, lambda: brief.brief_pack_plain(pb, ang))
    report["brief_pack"] = dict(
        source="orb_slam_system_tpu_torch/csrc/brief_pack.cu",
        replaces="orb_slam_system_tpu/ops/brief_pallas.py:68",
        max_abs_err=0.0, ms=ms_c, device_ms=dev_c, plain_ms=plain_c,
        # Blurred patches and angles read once, words written once; two
        # bf16 roundings and one compare per test.
        bound=bound_ms(4.0 * (pb.numel() + ang.numel() + kc.numel()),
                       3.0 * 256 * n_kp),
        library_ms=None)
    print(f"kernel C brief_pack: {tuple(kc.shape)} words bit-exact; call "
          f"{ms_c:.4f} ms, device {dev_c:.4f} ms (plain {plain_c:.4f} ms), "
          f"{card}", flush=True)

    kd = patches.gather_patches(canvas, xy_all, 21)
    pd = patches.gather_patches_plain(canvas, xy_all, 21)
    if not torch.equal(kd, pd):
        fail(f"kernel D differs in {int((kd != pd).sum())} values")
    flat_canvas = canvas.reshape(Bc, Hc * Wc)
    lib = torch.gather(flat_canvas, 1, flat).reshape(kd.shape)
    if not torch.equal(lib, kd):
        fail("torch.gather over the flat indices differs from kernel D")
    run_d = lambda: patches.gather_patches(canvas, xy_all, 21)
    run_lib_d = lambda: torch.gather(flat_canvas, 1, flat)
    ms_d = cuda_ms(torch, run_d)
    dev_d = device_ms(torch, run_d, "gather_patches_kernel")
    plain_d = cuda_ms(torch, lambda: patches.gather_patches_plain(
        canvas, xy_all, 21))
    lib_d = cuda_ms(torch, run_lib_d)
    lib_dev_d = device_ms(torch, run_lib_d, None)
    report["gather_patches"] = dict(
        source="orb_slam_system_tpu_torch/csrc/gather_patches.cu",
        replaces="orb_slam_system_tpu/ops/gather_pallas.py:113",
        max_abs_err=float((kd - pd).abs().max()), ms=ms_d, device_ms=dev_d,
        plain_ms=plain_d,
        # A copy: the windows' canvas and the centres read once, patches
        # written once.
        bound=bound_ms(4.0 * (n_read + xy_all.numel() + kd.numel()), 0.0),
        library_ms=lib_d, library_device_ms=lib_dev_d)
    print(f"kernel D gather_patches: {tuple(kd.shape)} bit-exact; call "
          f"{ms_d:.4f} ms, device {dev_d:.4f} ms (plain {plain_d:.4f} ms; "
          f"torch.gather over precomputed indices: call {lib_d:.4f} ms, "
          f"device {lib_dev_d:.4f} ms), {card}", flush=True)

    # The extractor's unfused route (kernels A, D, C); counts read around it.
    fb_unfused = FrameBuilder(cfg, dev, fused_gather=False)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    unfused = [fb_unfused.build(frames[i], i / 30.0)
               for i in range(N_UNFUSED_FRAMES)]
    torch.cuda.synchronize()
    unfused_launches = dict(kernels.LAUNCHES)
    for name in ("fast_score_nms", "gather_patches", "brief_pack"):
        if unfused_launches[name] != N_UNFUSED_FRAMES:
            fail(f"the unfused route launched {name} "
                 f"{unfused_launches[name]} times in {N_UNFUSED_FRAMES} frames")
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

    phases_done(3)
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
    check_build_launches("the slice", launches, N_FRAMES)
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
    report["pose_lm"] = check_kernel_e(torch, dev, Tcw, Xw, obs, inv_s2, ok,
                                       mono, cam, card)

    phases_done(4)
    # 5. The System, the main path; the counters and this thread's spans
    # count only this phase.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    take_spans()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        slam, ate = mono_synthetic.run(SYSTEM_FRAMES, out_dir, 1000, W, H,
                                       device="cuda", verbose=True)
        n_traj = len(open(os.path.join(out_dir, "CameraTrajectory.txt")).readlines())
    torch.cuda.synchronize()
    system_launches = dict(kernels.LAUNCHES)
    classic_frame_ms = 1e3 * slam.timing_report()["median_s"]
    recs = slam.telemetry.records
    phase5_track_ms = [r["track_ms"] for r in recs]
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
    lm_calls = sum(r["spans"].get("track.pose_lm", [0.0, 0])[1] for r in recs)
    print(f"pose LMs in the system run: {lm_calls} track.pose_lm span calls, "
          f"{system_launches['pose_lm']} launches of kernel E", flush=True)
    if lm_calls == 0 or system_launches["pose_lm"] != lm_calls:
        fail(f"the system run made {lm_calls} pose LMs and launched kernel E "
             f"{system_launches['pose_lm']} times")
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
    check_build_launches("the system run", system_launches, len(recs))
    pr = slam.place_rec
    if not pr.ready:
        fail("place recognition never became ready in the system run")
    unindexed = [k for k, kf in slam.arena.kfs.items()
                 if kf.bow is None or kf.node_ids is None or k not in pr.db.bows]
    if unindexed:
        fail(f"keyframes without BoW or database entry: {unindexed}")
    print(f"place recognition: self-trained vocabulary of {pr.vocab.n_words} "
          f"words (k={pr.vocab.k}, L={pr.vocab.L}), all "
          f"{slam.arena.n_keyframes()} live keyframes indexed", flush=True)

    reloc = relocalization_phase(torch, slam, kernels, pnp, unpack,
                                 Vocabulary, traj_io, mono_synthetic,
                                 TrackingState, card)

    phases_done(6)
    # 7. Loop closing; the counters count only this phase.
    loop = loop_phase(torch, dev, kernels, loop_synthetic, loop_closing, sim3,
                      pose_graph, local_ba, card)

    # 8. Stereo at KITTI width; 9. RGB-D and localization mode. The counters
    # count only each phase.
    phases_done(7)
    stereo = stereo_phase(torch, kernels, check_kernel_b, card)
    rgbd = rgbd_phase(torch, kernels, card)
    phases_done(9)
    # 10. The realtime modes; the counters count only each run.
    realtime = realtime_phase(torch, kernels, card, classic_frame_ms)
    phases_done(10)
    # 11. Sequences and maps from disk; the counters count only each run.
    sequences = sequences_phase(torch, kernels, card)
    phases_done(11)
    # 12. The multi-sequence mode; the counters count only each run.
    multiseq = multiseq_phase(torch, kernels, check_kernel_b, card)
    phases_done(12)
    # 13. The long run, then the viewer and AR; the counters count only each
    # run.
    long_run, long_slam, captured = long_run_phase(torch, kernels, card)
    view = viewer_phase(torch, kernels, long_slam, card)
    phases_done(13)
    # 14. The ROS nodes, the live and video drivers, the warm pass, then the
    # sharded solvers; the counters count only each run.
    bridge = bridge_phase(torch, kernels, card, phase5_track_ms)
    sharded = sharded_phase(torch, kernels, card, captured, long_run["solves"])
    phases_done(14)
    for name, key in (("fast_score_nms", "kernel_a"),
                      ("gather_blur_moments", "kernel_b")):
        for shape, ph in (("at_stereo_shape", stereo),
                          ("at_multiseq_shape", multiseq)):
            r = ph[key]
            report[name][shape] = dict(
                shape=r["shape"], launches_per_frame=r["launches_per_frame"],
                ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound"][0], bound_by=r["bound"][1])

    # Launches of each kernel on the path that runs it: the System for A,
    # B (its describe mode) and E, the extractor's unfused route for C and D.
    path_launches = dict(
        fast_score_nms=system_launches["fast_score_nms"],
        gather_blur_moments=system_launches["gather_blur_describe"],
        brief_pack=unfused_launches["brief_pack"],
        gather_patches=unfused_launches["gather_patches"],
        pose_lm=system_launches["pose_lm"])
    by_phase = {"unfused_route": unfused_launches, "slice": launches,
                "system": system_launches, "relocalization": reloc["launches"],
                "loop": loop["launches"], "stereo": stereo["launches"],
                "rgbd": rgbd["launches"],
                "realtime_pipelined": realtime["mono"]["launches"],
                "realtime_stream": realtime["stream"]["launches"],
                "realtime_loop": realtime["loop"]["launches"],
                "realtime_stereo": realtime["stereo"]["launches"],
                **{f"seq_{k}": v["launches"]
                   for k, v in sequences["runs"].items()},
                "seq_map_localization": sequences["map"]["launches"],
                "multiseq": multiseq["full"]["launches"],
                "multiseq_frontend": multiseq["frontend"]["launches"],
                "long_run": long_run["launches"], "ar": view["ar_launches"],
                **{k: bridge[k]["launches"] for k in (
                    "ros_mono", "ros_stereo", "ros_rgbd", "ros_ar", "live",
                    "video", "warm")},
                "dryrun": sharded["dryrun"]["launches"]}
    counter = dict(fast_score_nms="fast_score_nms",
                   gather_blur_moments="gather_blur_describe",
                   brief_pack="brief_pack", gather_patches="gather_patches",
                   pose_lm="pose_lm")
    print(json.dumps({"relocalization": reloc}), flush=True)
    print(json.dumps({"loop": loop}), flush=True)
    print(json.dumps({"stereo": stereo, "rgbd": rgbd}, default=str), flush=True)
    print(json.dumps({"realtime": realtime}, default=str), flush=True)
    print(json.dumps({"sequences": sequences}, default=str), flush=True)
    print(json.dumps({"multiseq": multiseq}, default=str), flush=True)
    print(json.dumps({"long_run": long_run, "viewer": view}, default=str),
          flush=True)
    print(json.dumps({"bridge": bridge, "sharded": sharded}, default=str),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": path_launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"],
         "library_device_ms": r.get("library_device_ms"),
         "launches_by_phase": {ph: c[counter[name]] for ph, c in by_phase.items()},
         **{k: r[k] for k in ("mode", "canvas_floats", "canvas_floats_read",
                              "blur_mode", "replaced_chain", "at_stereo_shape",
                              "at_multiseq_shape", "slots", "iterations")
                   if k in r}}
        for name, r in report.items()]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
