#!/usr/bin/env python3
"""The benchmark of orb_slam_system_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Runs one workload of BENCHMARK.json once:
set-up (frames rendered from the seed, the program built and warmed), a
measured window of `--seconds`, then the check of what the window produced
against the benchmark's plain references. Prints the numbers compared,
each with its limit, as the last lines of standard error, and one JSON
result as the last line of standard output: with --trace 0 the
workload's end-to-end metrics, with --trace 1 its per-layer metrics from a
profiled sub-window. Exits non-zero, printing no result, without a GPU,
when the program cannot be imported, or when JAX or the JAX package was
loaded. See benchmark/README.md for how cells, configurations, traffic and
metrics are added.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# One process with few threads: the program is bound by its host thread, so
# BLAS and OpenMP pools that spin beside it only add noise.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam_system_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package
    (whole names: the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    # Build and kernel caches stay inside the checkout, at fixed paths.
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    from harness.registry import Registry
    chips = int(Registry(ROOT).workload(a.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: this workload needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    from harness import cell
    result = cell.run(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                      t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"run.py: the run loaded {bad}: no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
