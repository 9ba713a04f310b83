"""Shared plumbing of the dataset drivers (the JAX package's
examples/_driver_util.py): the command line, prefetched image reading, the
paced tracking loop and the exit report."""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from orb_slam_system_tpu_torch.native import PrefetchLoader


def parse_args(doc: str, positional: Sequence[str], argv=None):
    """The dataset drivers' command line: parse_command's, then
    --no-realtime (do not pace frames to the dataset's timestamps) and
    --out-dir (where the trajectory files go, the working directory by
    default)."""
    def flags(ap):
        ap.add_argument("--no-realtime", action="store_true")
        ap.add_argument("--out-dir", default=".")
    return parse_command(doc, positional, argv, flags)


def parse_command(doc: str, positional: Sequence[str], argv=None,
                  flags: Optional[Callable] = None):
    """The reference drivers' positional arguments, --device (cuda by
    default; cpu runs the plain PyTorch paths) and whatever `flags(parser)`
    adds. args.vocabulary is None for a vocabulary path of "none", which
    self-trains the vocabulary from the map."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    for name in positional:
        ap.add_argument(name)
    add_device_arg(ap)
    if flags is not None:
        flags(ap)
    args = ap.parse_args(argv)
    voc = args.path_to_vocabulary
    args.vocabulary = None if voc.lower() == "none" else voc
    return args


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    """--device: cuda by default; cpu runs the plain PyTorch paths."""
    ap.add_argument("--device", default="cuda")


def make_fetcher(paths: List[str], raw16: bool = False) -> PrefetchLoader:
    """The native prefetch ring over `paths` (fetch(i) -> f32[H,W]). It
    raises when the decoder cannot be built or a frame cannot be decoded;
    unlike the JAX helper (examples/_driver_util.py:12-25) there is no
    silent fallback to another decoder."""
    return PrefetchLoader(paths, raw16=raw16)


def track_sequence(times: List[float], load: Callable[[int], tuple],
                   track: Callable, realtime: bool) -> List[float]:
    """For every frame i, track(*load(i), t): the seconds each track call
    took (the frame's reading is outside them, as in the reference); with
    `realtime`, sleep so frames follow the dataset's timestamps (reference
    mono_tum.cc:97-105)."""
    track_times = []
    for i, t in enumerate(times):
        args = load(i)
        t0 = time.perf_counter()
        track(*args, t)
        dt = time.perf_counter() - t0
        track_times.append(dt)
        if realtime and i + 1 < len(times):
            wait = times[i + 1] - t - dt
            if wait > 0:
                time.sleep(wait)
    return track_times


def print_timing_report(track_times):
    """The reference drivers' exit report (mono_tum.cc:111-120)."""
    tt = np.sort(np.asarray(track_times))
    print("-------")
    print(f"median tracking time: {tt[len(tt) // 2]:.5f}")
    print(f"mean tracking time: {tt.mean():.5f}")


def out_path(args, name: str) -> str:
    """`name` under the driver's --out-dir (made if missing)."""
    os.makedirs(args.out_dir, exist_ok=True)
    return os.path.join(args.out_dir, name)
