"""One-command dataset validation for the port (the JAX package's
tools/run_dataset.py).

    python -m orb_slam_system_tpu_torch.drivers.run_dataset \\
        /data/rgbd_dataset_freiburg1_xyz --voc /data/ORBvoc.txt --max-ate 0.05

It detects the dataset's layout, picks the matching driver and shipped
settings file (the package's settings/, copies of examples/settings/),
loads the vocabulary first (so a bad path fails in seconds, not after the
run), runs the driver in this process (one CUDA context; the kernel and
decoder libraries load once), then associates the trajectory it wrote
with the dataset's ground truth and prints the ATE
(drivers/evaluate_ate.py; Sim3-aligned for the monocular kinds).
--device cpu runs the plain PyTorch paths.

Layout detection:
  * TUM mono:   <dir>/rgb.txt                     -> drivers/mono_tum
  * TUM RGB-D:  <dir>/rgb.txt + depth.txt + associations.txt
                (or --sensor rgbd)                -> drivers/rgbd_tum
  * KITTI:      <dir>/image_0 + times.txt         -> drivers/mono_kitti
                (--sensor stereo + image_1        -> drivers/stereo_kitti)
  * EuRoC:      <dir>/mav0/cam0/data + --timestamps
                                                  -> drivers/mono_euroc
Ground truth: <dir>/groundtruth.txt unless --gt (KITTI: poses/NN.txt).

Departures from the JAX tool; the first two are faults there:
  * EuRoC: the driver gets <dir>/mav0/cam0, the folder that holds data/;
    tools/run_dataset.py:108-109 passes <dir>, so the JAX driver looks for
    <dir>/data/<ns>.png, which EuRoC's layout does not have.
  * KITTI mono: the KITTI-format ground truth is stamped with the
    sequence's times.txt before association (evaluate_ate --gt_times), so
    each keyframe of KeyFrameTrajectory.txt (TUM format, stamped in
    seconds) pairs with its own pose; tools/evaluate_ate.py:54-58 stamps it
    with line indices 0, 1, 2, ..., which pairs the wrong poses or none.
    KITTI stereo writes CameraTrajectory.txt in KITTI format itself and
    keeps association by line index.
  * TUM RGB-D: the ATE is taken over CameraTrajectory.txt, every frame
    (the TUM benchmark's measure), not over the keyframes
    (tools/run_dataset.py:125-126): a depth map seeded from one view may
    keep a single keyframe over a short sequence, too few poses to align.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

# Copies of the JAX package's examples/settings files that detect() names,
# so the port runs outside a checkout of the repo.
SETTINGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "settings")


def detect(seq_dir: str, sensor: str):
    """Returns (kind, driver module under drivers/, default settings)."""
    if os.path.exists(os.path.join(seq_dir, "rgb.txt")):
        if (sensor == "rgbd"
                or (sensor == "auto"
                    and os.path.exists(os.path.join(seq_dir, "depth.txt"))
                    and os.path.exists(os.path.join(seq_dir,
                                                    "associations.txt")))):
            return ("tum_rgbd", "rgbd_tum", "tum1.yaml")
        return ("tum_mono", "mono_tum", "tum1.yaml")
    if os.path.isdir(os.path.join(seq_dir, "image_0")):
        if sensor == "stereo" and os.path.isdir(
                os.path.join(seq_dir, "image_1")):
            return ("kitti_stereo", "stereo_kitti", "kitti00-02.yaml")
        return ("kitti_mono", "mono_kitti", "kitti00-02.yaml")
    if os.path.isdir(os.path.join(seq_dir, "mav0")):
        return ("euroc_mono", "mono_euroc", "euroc_mono.yaml")
    raise SystemExit(f"unrecognized dataset layout under {seq_dir} "
                     "(expected rgb.txt, image_0/, or mav0/)")


def prevalidate_vocabulary(voc: str):
    """Load the vocabulary now (text parse + npz cache) so a bad path or a
    truncated file fails before the run, and report its shape; the driver
    then loads it from the cache."""
    from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary
    print(f"pre-validating vocabulary: {voc}")
    v = Vocabulary.load(voc)
    print(f"  ok: k={v.k} L={v.L} nodes={len(v.node_desc)} "
          f"words={v.n_words}")


def driver_argv(kind: str, args, settings: str) -> list:
    """The driver's command line for this dataset."""
    seq = args.seq_dir
    if kind == "euroc_mono":
        if not args.timestamps:
            raise SystemExit("EuRoC needs --timestamps")
        # The camera's folder, which holds data/ (module docstring).
        argv = [args.voc, settings, os.path.join(seq, "mav0", "cam0"),
                args.timestamps]
    else:
        argv = [args.voc, settings, seq]
        if kind == "tum_rgbd":
            argv.append(os.path.join(seq, "associations.txt"))
    argv += ["--device", args.device, "--out-dir", args.out_dir]
    if not args.realtime:
        argv.append("--no-realtime")
    return argv


def eval_argv(kind: str, args, gt: str, traj: str) -> list:
    """evaluate_ate's command line for this dataset's trajectory."""
    argv = [gt, traj]
    if kind in ("tum_mono", "kitti_mono", "euroc_mono"):
        argv.append("--scale")   # monocular: Sim3 alignment
    if kind == "kitti_mono":
        argv += ["--gt_times", os.path.join(args.seq_dir, "times.txt")]
    if args.max_ate is not None:
        argv += ["--max_ate", str(args.max_ate)]
    return argv


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("seq_dir")
    ap.add_argument("--voc", default="none",
                    help="ORBvoc.txt path ('none' = self-trained)")
    ap.add_argument("--settings", default=None,
                    help="settings yaml (default: by dataset kind)")
    ap.add_argument("--sensor", default="auto",
                    choices=["auto", "mono", "stereo", "rgbd"])
    ap.add_argument("--gt", default=None,
                    help="ground-truth file (default: <dir>/groundtruth.txt)")
    ap.add_argument("--timestamps", default=None,
                    help="EuRoC timestamp file")
    ap.add_argument("--max-ate", type=float, default=None,
                    help="fail (exit 1) if ATE RMSE exceeds this [m]")
    ap.add_argument("--out-dir", default=".",
                    help="where the driver writes trajectories")
    ap.add_argument("--realtime", action="store_true",
                    help="pace frames to dataset timestamps (default: "
                         "unpaced; ATE does not depend on pacing)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    kind, driver, default_settings = detect(args.seq_dir, args.sensor)
    settings = args.settings or os.path.join(SETTINGS, default_settings)
    print(f"dataset kind: {kind}\ndriver: drivers/{driver}\n"
          f"settings: {settings}")
    if args.voc.lower() != "none":
        prevalidate_vocabulary(args.voc)

    d_argv = driver_argv(kind, args, settings)
    print(f"running: drivers/{driver}", " ".join(d_argv), flush=True)
    module = importlib.import_module(f"orb_slam_system_tpu_torch.drivers.{driver}")
    rc = module.main(d_argv)
    if rc != 0:
        return rc

    traj_name = ("CameraTrajectory.txt" if kind in ("kitti_stereo",
                                                     "tum_rgbd")
                 else "KeyFrameTrajectory.txt")
    traj = os.path.join(args.out_dir, traj_name)
    if not os.path.exists(traj):
        raise SystemExit(f"driver wrote no {traj_name}")
    print(f"trajectory: {traj}")
    gt = args.gt or os.path.join(args.seq_dir, "groundtruth.txt")
    if not os.path.exists(gt):
        print(f"no ground truth at {gt}: skipping ATE (run "
              f"drivers/evaluate_ate.py when it exists)")
        return 0
    from orb_slam_system_tpu_torch.drivers import evaluate_ate
    e_argv = eval_argv(kind, args, gt, traj)
    print("evaluating:", " ".join(e_argv), flush=True)
    return evaluate_ate.main(e_argv)


if __name__ == "__main__":
    sys.exit(main())
