"""Run the warm pass once (the JAX package's tools/warm_cache.py).

    python -m orb_slam_system_tpu_torch.drivers.warm_cache [n_frames] \\
        [--settings PATH] [--device cuda|cpu]

Thin command line over utils/warmup.warm, the pass System(...,
prewarm=True) runs at construction: n_frames (72 by default) of a synthetic
orbit at the settings' camera and ORB parameters (640x480, 1000 features
without --settings) through the sequential + synchronous and the pipelined
+ async modes. Prints the seconds of each mode and the shared libraries
built (the CUDA kernel library, the native loader) where the JAX tool
prints its XLA cache entries.
"""

from __future__ import annotations

import argparse
import sys

from orb_slam_system_tpu_torch.config import Sensor, load_settings
from orb_slam_system_tpu_torch.drivers._driver_util import add_device_arg
from orb_slam_system_tpu_torch.utils.warmup import warm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_frames", nargs="?", type=int, default=72)
    ap.add_argument("--settings", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    cfg = (load_settings(args.settings, Sensor.MONOCULAR)
           if args.settings else None)
    warm(cfg, args.n_frames, verbose=True, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
