#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code != 0) when it fails:
  1. print the card's name and power limit (nvidia-smi) and torch's CUDA;
  2. build the four CUDA kernels from orb_slam_system_tpu_torch/csrc (one
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
     CPU path;
  5. run the System (the main path): System.track_monocular over a
     60-frame 640x480 orbit through drivers/mono_synthetic.run: two-view
     initialization on the 2048-slot builder, keyframes, local mapping;
     print per-frame and
     per-stage times, a profiler count of one keyframe insertion and one
     local BA, and check the reference's bars (state OK, >= 3 keyframes,
     > 150 map points, ATE < 3 cm) plus >= 90% of the frames after
     initialization tracked, that every kernel of the path launched
     (kernel A and kernel B's describe mode once per frame build, kernel C
     never), and that place recognition became ready (the vocabulary
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
     each loop and mapping stage, and the device kernels and ms of
     sim3_ransac_batch, optimize_sim3, optimize_essential_graph and one
     global-BA chunk, each re-run on the inputs the run gave it, and the
     global-BA solver the run did not take (dense Schur or PCG) on the
     same chunk.
The second-to-last line is a JSON object with each kernel's launches (on the
path that runs it, and in every phase), error, times and bound; the last
line is {"ok": true, "device": {...}}. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
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
MAX_RELOC_ERR_M = 0.01      # relocalized camera centre vs the tracked one
MIN_TRACKED_SHARE = 0.9     # of the System's frames after initialization
MAX_ATE_M = 0.03            # tests/test_e2e_mono.py bar
LOOP_FRAMES = 90            # tests/test_e2e_loop.py's short circle
MIN_LOOP_TRACKED = 80       # ... and its bars
MAX_LOOP_ATE_M = 0.10
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


def stage_device_ms(torch, fn, reps: int = 20):
    """(device ms per call of fn summed over every kernel it launches, the
    kernels per call). One call's kernels, by name, come from single-call
    windows, two of which must agree; the time from a window of `reps`
    calls that holds exactly `reps` times those records. The profiler can
    drop records, so each kind of window is profiled again, up to 5; the
    run fails if none qualifies."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        one = _stage_window(torch, fn, 1)[0]
        if one and one in seen:
            break
        seen.append(one)
    else:
        fail(f"no two single-call profiler windows of the stage agree: "
             f"{[sum(c.values()) for c in seen]} records")
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
    fail(f"the profiler never showed {reps} times the {sum(one.values())} "
         f"kernels of one call of the stage")


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
    the run; if the profiler itself fails, say so and go on."""
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
        return
    n = sum(e.count for e in evs)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    print(f"{label}: {n} device kernels, {dev_ms:.3f} ms summed device "
          f"time (profiler), wall {wall_ms:.3f} ms, device idle share "
          f"{1.0 - dev_ms / wall_ms:.3f}", flush=True)


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
    for name, want in (("fast_score_nms", 3), ("gather_blur_describe", 3),
                       ("brief_pack", 0)):
        if launches[name] != want:
            fail(f"kernel {name} launched {launches[name]} times in phase 6's "
                 f"3 frame builds, not {want}")
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
    for name, want in (("fast_score_nms", LOOP_FRAMES),
                       ("gather_blur_describe", LOOP_FRAMES),
                       ("brief_pack", 0), ("gather_blur_moments", 0),
                       ("gather_patches", 0)):
        if launches[name] != want:
            fail(f"kernel {name} launched {launches[name]} times in the loop "
                 f"circle's {LOOP_FRAMES} frame builds, not {want}")
    keys = ("sim3_ransac_batch", "optimize_sim3", "optimize_essential_graph",
            "gba_chunk")
    missing = [k for k in keys if k not in captured]
    if missing:
        fail(f"the loop circle never called {missing}")
    solves = {}
    for name in keys:
        f, a, kw = captured[name]
        fn = (lambda f=f, a=a, kw=kw: f(*a, **kw))
        call_ms = cuda_ms(torch, fn, reps=3)
        d_ms, n_k = stage_device_ms(torch, fn, reps=3)
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
        print(f"{label} on the run's inputs {shapes}: {n_k} device kernels, "
              f"{d_ms:.3f} ms summed device time (profiler), call {call_ms:.3f} "
              f"ms (CUDA events), device idle share "
              f"{1.0 - d_ms / call_ms:.3f}; {card}", flush=True)
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
    d_ms, n_k = stage_device_ms(torch, fn, reps=3)
    solves["gba_chunk_other_solver"] = dict(
        device_ms=d_ms, kernels=n_k, call_ms=call_ms,
        shapes=solves["gba_chunk"]["shapes"], solver=other)
    taken = solves["gba_chunk"]
    print(f"global-BA chunk by solver at {taken['shapes'][0][0]} keyframes "
          f"(GBA_DENSE_MAX_CAMS {loop_closing.GBA_DENSE_MAX_CAMS}): "
          f"{taken['solver']} (taken) {taken['device_ms']:.3f} ms device / "
          f"{taken['call_ms']:.3f} ms call, {other} {d_ms:.3f} ms device / "
          f"{call_ms:.3f} ms call in {n_k} kernels; {card}", flush=True)
    return dict(last_loop=lc.last_loop, n_tracked=n_tracked, ate_cm=100 * ate,
                keyframes=slam.arena.n_keyframes(), points=slam.arena.n_points(),
                gba=gba_when, stats=dict(lc.stats), launches=launches,
                wall_s=wall_s, stage_ms=stage_ms, solves=solves)


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
        from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary
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

    def check_kernel_b(canvas, xy):
        """Both modes of kernel B against their plain versions: blur mode
        bit-exact (moments within 0.5); describe mode's moments bit-equal
        to blur mode's, its angle to angles_from_moments of them, its
        descriptors to brief_pack_plain of the plain blur at that angle."""
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

    ex_init = FrameBuilder(cfg, dev, n_features=2 * cfg.orb.n_features).extractor
    check_kernel_b(*ex_init.detect(img)[1:])
    _, canvas, xy_all = ex.detect(img)
    pb, pm, mom_err = check_kernel_b(canvas, xy_all)
    n_kp = xy_all.shape[1]
    pb_side = pb.shape[-1]
    # Bytes the gathers of kernels B and D must read: the canvas inside the
    # union of the keypoints' clipped 43x43 windows. The rest of the canvas
    # is filler (each level padded to the widest, rows rounded up to 8) and
    # canvas that no keypoint of this frame reaches.
    Bc, Hc, Wc = canvas.shape
    flat = patches.gather_flat_index(xy_all, 21, Hc, Wc)
    n_read = int(torch.zeros((Bc, Hc * Wc), dtype=torch.bool, device=dev)
                 .scatter_(1, flat, True).sum())
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
    # Describe stage: the windows' canvas and the centres read once;
    # moments, angle and descriptor written once; the first pass, the second
    # at the 512 test points, the moments, the tests. The chain moves the
    # blurred patch out and back in, and the angle through device memory.
    bound_s = bound_ms(4.0 * (n_read + xy_all.numel() + 11 * n_kp),
                       n_kp * (ops_pass1 + 2 * 7 * 512 + 4 * 749) + ops_c)
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
    for name, want in (("fast_score_nms", N_FRAMES),
                       ("gather_blur_describe", N_FRAMES), ("brief_pack", 0)):
        if launches[name] != want:
            fail(f"kernel {name} launched {launches[name]} times in the "
                 f"slice's {N_FRAMES} frame builds, not {want}")
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
    for name, want in (("fast_score_nms", len(recs)),
                       ("gather_blur_describe", len(recs)), ("brief_pack", 0)):
        if system_launches[name] != want:
            fail(f"kernel {name} launched {system_launches[name]} times for "
                 f"{len(recs)} frame builds in the system run, not {want}")
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

    # 7. Loop closing; the counters count only this phase.
    loop = loop_phase(torch, dev, kernels, loop_synthetic, loop_closing, sim3,
                      pose_graph, local_ba, card)

    # Launches of each kernel on the path that runs it: the System for A and
    # B (its describe mode), the extractor's unfused route for C and D.
    path_launches = dict(
        fast_score_nms=system_launches["fast_score_nms"],
        gather_blur_moments=system_launches["gather_blur_describe"],
        brief_pack=unfused_launches["brief_pack"],
        gather_patches=unfused_launches["gather_patches"])
    by_phase = {"unfused_route": unfused_launches, "slice": launches,
                "system": system_launches, "relocalization": reloc["launches"],
                "loop": loop["launches"]}
    counter = dict(fast_score_nms="fast_score_nms",
                   gather_blur_moments="gather_blur_describe",
                   brief_pack="brief_pack", gather_patches="gather_patches")
    print(json.dumps({"relocalization": reloc}), flush=True)
    print(json.dumps({"loop": loop}), flush=True)
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
                              "blur_mode", "replaced_chain") if k in r}}
        for name, r in report.items()]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
