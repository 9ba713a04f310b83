"""One run of one workload: set-up, the measured window, the check.

Set-up lays out every camera's path and textured ground, builds the
program's entry and hands in frames (with the right view or the depth
image where the configuration's sensor gives one) until the traffic's warm
condition holds (the cameras initialized and tracking, the self-trained
vocabulary built, the cell's shapes seen). The window then hands in the
next frames in a closed loop (the next frame as soon as the last returned,
as ORB-SLAM2's own mono_tum / mono_euroc drivers do whenever tracking is
slower than the camera) for `seconds`, and the run reads the device's
memory peak. Frames
are rendered a chunk at a time as the run reaches them; in the window the
clock stops while a chunk renders, after the device has finished the
program's work, so the window holds the program's time alone. Only
after that is the program's state copied to the host and freed, and the
references run.

With trace on, a few frames inside the window run under the profiler; the
per-layer metrics are read from them and from the window's telemetry.
"""

from __future__ import annotations

import gc
import re
import sys
import time

import numpy as np

from harness import judge, scene, stats, tracing
from harness.registry import Registry


class RunContext:
    """What a per-layer metric's reader may read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def slam_config(cfg: dict):
    """The program's SlamConfig of a configuration: its camera (with
    Camera.bf where it gives `bf`), ORB settings and sensor; `th_depth` is
    ThDepth as a settings file gives it, converted to metres as the
    program's load_settings does, and `depth_map_factor` DepthMapFactor."""
    from orb_slam_system_tpu_torch.config import (CameraConfig, ORBConfig,
                                                  Sensor, SlamConfig,
                                                  th_depth_metres)
    cam = cfg["camera"]
    camera = CameraConfig(**{k: cam[k] for k in (
        "fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "bf", "fps",
        "width", "height") if k in cam})
    sensor = Sensor[scene.sensor_of(cfg).upper()]
    depth = {}
    if "th_depth" in cfg:
        depth["th_depth"] = th_depth_metres(float(cfg["th_depth"]), camera, sensor)
    if "depth_map_factor" in cfg:
        depth["depth_map_factor"] = float(cfg["depth_map_factor"]) or 1.0
    return SlamConfig(camera=camera, orb=ORBConfig(**cfg["orb"]), sensor=sensor,
                      **depth)


def end_to_end(name: str, frames: int, window_s: float, latencies, setup_s: float,
               log, meter=None) -> float:
    """fps: frames completed over the window's whole time; frame_ms_pNN:
    the NN-th percentile (nearest rank) of every window frame's time from
    hand-in to returned pose; setup_s: process start to window start;
    kernel_ms_per_frame: the card's kernel time (the union of its kernels'
    intervals, copies left out) over every window frame, per frame."""
    if name == "fps":
        return frames / window_s
    if name == "setup_s":
        return setup_s
    if name == "kernel_ms_per_frame":
        return 1e3 * meter.kernel_s / frames
    m = re.fullmatch(r"frame_ms_p(\d+)", name)
    if m is None:
        raise KeyError(f"no end-to-end metric {name!r}")
    q = int(m.group(1)) / 100.0
    print(f"{name} over {len(latencies)} frames, "
          f"{stats.beyond(len(latencies), q)} beyond it", file=log)
    return 1e3 * stats.nearest_rank(latencies, q)


def _state_ok(system) -> bool:
    from orb_slam_system_tpu_torch.config import TrackingState
    return system.tracker.state == TrackingState.OK


def run(root: str, workload: str, seed: int, seconds: int, trace: bool,
        device: str = "cuda", t_start: float | None = None, log=sys.stderr,
        on_check=None):
    """Runs the workload once; returns the result dict (the line's keys).
    on_check(**what the check read), where given, is called after the
    check: the control and the calibration read the same inputs."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    reg = Registry(root)
    cell = reg.workload(workload)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    limits = reg.limits(workload)
    cam = cfg["camera"]
    n_cams = int(cfg["cameras"])
    on_card = torch.device(device).type == "cuda"
    torch.manual_seed(seed)
    np.random.seed(seed % 2 ** 32)

    # Frames: every camera's path and ground, rendered on the device as the
    # run reaches them; a rig's second stream (right view or depth image)
    # in the same chunks as its first. `second` names the entry's argument
    # for it; of a camera's streams the program extracts the first
    # n_extracted.
    sensor = scene.sensor_of(cfg)
    second = {"stereo": "right", "rgbd": "depth"}.get(sensor)
    n_extracted = 2 if sensor == "stereo" else 1
    paths, views = [], []
    for s in range(n_cams):
        poses, seg_of, streams = scene.camera_streams(cfg, traffic, seconds,
                                                      seed * 16 + s, device)
        views.append(streams)
        paths.append((poses, seg_of))
    frames = [v[0] for v in views]
    seg_of = paths[0][1]
    n_frames = len(seg_of)

    def render_to(n):
        for v in views:
            for fs in v:
                fs.render_to(n)

    render_to(1)
    print(f"{n_cams} x {n_frames} frames laid out by "
          f"{time.perf_counter() - t_start:.3f} s", file=log, flush=True)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    from orb_slam_system_tpu_torch.utils import kernels as program_kernels
    entry = reg.entry(cfg["entry"]).Entry(slam_config(cfg), n_cams, device)
    systems = entry.systems
    fps_cam = float(cam["fps"])
    batch = np.empty((n_cams, int(cam["height"]), int(cam["width"])), np.uint8)
    if second:
        batch2 = np.empty_like(batch, dtype=views[0][1].frames.dtype)

    def hand_in(i):
        for s in range(n_cams):
            batch[s] = frames[s][i]
            if second:
                batch2[s] = views[s][1][i]
        if second:
            return entry.step(batch, i / fps_cam, **{second: batch2})
        return entry.step(batch, i / fps_cam)

    # Set-up: every segment but the last is handed in whole; the window
    # starts in the last one once the warm condition holds.
    warm = traffic["warm"]
    last_seg = len(traffic["path"]) - 1
    i = 0
    since_ok = 0
    while True:
        if i >= n_frames:
            raise RuntimeError("the frames ran out before the window started")
        if seg_of[i] != seg_of[max(i - 1, 0)] or i == 0:
            if traffic["path"][seg_of[i]].get("localization"):
                for sy in systems:
                    sy.activate_localization_mode()
                since_ok = 0
        if seg_of[i] == last_seg and i >= int(warm.get("min_frame", 0)) \
                and since_ok >= int(warm["frames"]) and all(
                sy.arena.n_keyframes() >= int(warm["min_keyframes"])
                and sy.place_rec.ready for sy in systems):
            break
        render_to(i + 1)
        hand_in(i)
        i += 1
        since_ok = since_ok + 1 if all(_state_ok(sy) for sy in systems) else 0
        if i > int(warm["max_setup_frames"]):
            raise RuntimeError(f"not warm after {i} frames: states "
                               f"{[int(sy.tracker.state) for sy in systems]}")
    if on_card:
        torch.cuda.synchronize()
    first = i
    tel0 = [len(sy.telemetry.records) for sy in systems]
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: window starts at frame {first} of {n_frames}, "
          f"{frames[0].ready} rendered", file=log, flush=True)

    # The window.
    # trace_frames counts frames over all cameras: whole rounds, at least one.
    n_trace = max(int(traffic["trace_frames"]) // n_cams, 1) if trace else 0
    trace_at = first + int(traffic["trace_start_frame"])
    lat, poses_out, feats, traced_imgs = [], [], [], []
    traced = None

    def step(j):
        poses_out.append((j, hand_in(j)))
        feats.append([sy.tracker.current.packed for sy in systems])

    paused = 0.0

    def ready(n):
        """Frames [0, n) rendered; returns the seconds a render took (after
        the device finished the program's queued work), 0 if none was due."""
        if frames[0].ready >= n:
            return 0.0
        # The kernel meter's session closes first: renders are not the
        # program's kernels.
        closed = meter.close() if meter is not None else 0.0
        if on_card:
            torch.cuda.synchronize()
        a = time.perf_counter()
        render_to(n)
        return closed + time.perf_counter() - a

    # An end-to-end metric on the device's clock: the whole window runs
    # under the kernel meter's sessions (a traced run reads its per-layer
    # metrics without it).
    meter = None
    if on_card and not trace and any(
            m["source"] == "device_trace" for m in reg.end_to_end(workload)):
        meter = tracing.KernelMeter(torch)
    launches0 = dict(program_kernels.LAUNCHES)
    t0 = time.perf_counter()
    while True:
        if i + max(n_trace, 1) > n_frames:
            # Faster than the camera: the stream ends the window.
            print(f"the frames ran out at {i}: the window ends there",
                  file=log, flush=True)
            break
        paused += ready(i + (n_trace if i == trace_at and n_trace else 1))
        if i == trace_at and n_trace:
            lo = i
            traced = tracing.profile_frames(
                torch, lambda: [step(j) for j in range(lo, lo + n_trace)], n_trace)
            # Every image the program extracts, a round's as one build's
            # batch: a stereo pair's two views go through one launch.
            traced_imgs = [np.stack([fs[j] for v in views for fs in v[:n_extracted]])
                           for j in range(lo, lo + n_trace)]
            i += n_trace
            if time.perf_counter() - t0 - paused >= seconds:
                break
        else:
            if meter is not None:
                paused += meter.open()
            a = time.perf_counter()
            step(i)
            b = time.perf_counter()
            lat.append(b - a)
            i += 1
            if meter is not None and meter.due():
                paused += meter.close()
                b = time.perf_counter()
            # A traced run's window lasts until its profiled frames are done.
            if b - t0 - paused >= seconds and (traced is not None or not n_trace):
                break
    if meter is not None:
        paused += meter.close()
        print(f"kernel meter: {meter.kernels} kernels on the card, {meter.launches} "
              f"launched by the host, records lost {meter.records_lost}, "
              f"{meter.sessions} sessions, {meter.kernel_s:.4f} s of kernels",
              file=log, flush=True)
    window_s = time.perf_counter() - t0 - paused
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_window = len(poses_out)

    # Copy what the check reads, then free the program's state.
    rng = np.random.default_rng([seed % 2 ** 63, 0xC4EC])
    n_check = min(int(traffic["check_frames"]), n_window)
    picks = sorted(rng.choice(n_window * n_cams, n_check, replace=False).tolist())
    # A rig's packed rows add u_right and depth after the left or colour
    # view's 16 columns.
    samples = [(frames[p % n_cams][poses_out[p // n_cams][0]],
                feats[p // n_cams][p % n_cams][:, :16].cpu().numpy())
               for p in picks]
    del feats
    cameras = [([j for j, _p in poses_out], [p[s] for _j, p in poses_out],
                paths[s][0]) for s in range(n_cams)]
    maps = []
    for s, sy in enumerate(systems):
        kfs = [(kf.timestamp, np.array(kf.Tcw, np.float64), kf.feats.xy_und.copy(),
                kf.feats.octave.copy(), kf.mp_ids.copy())
               for kf in sy.arena.kfs.values() if not kf.bad]
        pts = {m.id: np.array(m.pos, np.float64) for m in sy.arena.mps.values()
               if not m.bad}
        maps.append((kfs, pts, paths[s][0]))
    tel = [sy.telemetry.records[t:] for sy, t in zip(systems, tel0)]
    launches = {k: v - launches0[k] for k, v in program_kernels.LAUNCHES.items()}
    del entry, systems
    for v in views:
        for fs in v:
            fs.renderer = None
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = {}
    ext = judge.extraction(samples, cfg["orb"], device)
    numbers.update({k: v for k, v in ext.items() if k != "reference"})
    numbers.update(judge.tracking(cameras))
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]])
    numbers.update(judge.mapping(maps, K, float(cfg["orb"]["scale_factor"])))
    if on_check is not None:
        on_check(numbers=numbers, samples=samples, cameras=cameras, maps=maps,
                 cfg=cfg, K=K, device=device, fps=fps_cam)
    correct, checks = judge.verdict(numbers, limits)
    print(f"check {time.perf_counter() - t_check:.3f} s", file=log, flush=True)
    for k, v in numbers.items():
        if k not in checks:
            print(f"also read: {k} {v!r}", file=log)

    failed = sum(p is None for _j, ps in poses_out for p in ps)
    done = n_window * n_cams
    timed = lat
    result = {"correct": bool(correct), "attempted": done, "failed": failed}
    ctx = RunContext(frames=done, window_s=window_s, latencies=timed,
                     telemetry=tel, trace=traced, setup_s=setup_s, cfg=cfg,
                     traffic=traffic, traced_images=traced_imgs,
                     traced_range=(trace_at - first, trace_at - first + n_trace),
                     n_cams=n_cams, launches=launches, device=device,
                     registry=reg, device_name=(torch.cuda.get_device_name(0)
                                                if on_card else "cpu"))
    kfs = [r[-1]["n_kfs"] - r[0]["n_kfs"] for r in tel if r]
    q = np.percentile(timed, [10, 50, 90, 100]) * 1e3 if timed else []
    print(f"window {window_s:.3f} s (renders {paused:.3f} s left out), "
          f"{done} frames ({n_window} rounds), "
          f"{failed} LOST, keyframes made {kfs}; frame ms p10/p50/p90/max "
          f"{np.round(q, 1).tolist()}; launches {launches}", file=log, flush=True)
    metrics = {}
    if not trace:
        for m in reg.end_to_end(workload):
            if m["source"] == "device_trace" and meter is None:
                continue  # no card: nothing on the device's clock
            metrics[m["name"]] = {"value": end_to_end(m["name"], done, window_s,
                                                      timed, setup_s, log, meter),
                                  "unit": m["unit"]}
    else:
        for m in reg.per_layer(workload):
            v = reg.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else "cpu",
                        "kind": ctx.device_name,
                        "count": int(cell["chips"]),
                        "memory_peak_bytes": int(memory_peak)}
    if trace and traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result
